"""Analytic stage-2 and stage-3 cost model (the paper's §III-C/D
performance model): ranks configurations before any kernel runs, so the
search (``autotune/search.py``) times only the top of the ranking.

A copy of the reference's ``autotune/model.py``, its formulas unchanged,
for this package's kernels:

* **bytes moved** — one super-step streams the block ``(H, W_K)``,
  ``H = b_in + 2*tw + 1``, ``W_K = fuse*b_in + tw + 1``, through fast memory
  once per K cycles: ``2*H*W_K/K`` words per chase cycle;
* **launch overhead** — one launch per (super-)cycle, whatever the batch;
* **wavefront occupancy** — paper Eq. 1: bandwidth scales with the share of
  the execution units the ``batch * G`` windows cover, at most 1;
* **feasibility** — a candidate whose ``tuning.smem_bytes`` (the chase
  kernels' shared memory per block) exceeds the profile's
  ``fast_mem_bytes`` costs ``inf``.

The profile table describes the NVIDIA H100 (the port's card), a generic
GPU and the CPU.  The reference's TPU rows and its ``roofline/`` constants
are not carried over.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bulge_chasing as bc
from repro_torch.core import tuning

__all__ = [
    "DeviceProfile", "PROFILES", "device_kind", "profile_for",
    "total_chase_cycles", "CostBreakdown", "stage_cost", "pipeline_cost",
    "fused_cost", "predicted_crossover", "FUSED_FAST_BW_RATIO",
    "stage3_cost", "predicted_stage3_crossover", "DC_DEFLATION_FACTOR",
]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """What the cost model needs to know about one device kind:
    ``mem_bw`` the device-memory stream rate (bytes/s),
    ``launch_overhead_s`` the fixed cost of one launch, ``fast_mem_bytes``
    the per-block budget a working set must fit (shared memory on a GPU),
    ``execution_units`` the units a wavefront must cover (SMs)."""
    device_kind: str
    mem_bw: float
    launch_overhead_s: float
    fast_mem_bytes: int
    execution_units: int


PROFILES: dict[str, DeviceProfile] = {
    # H100 SXM: 3.35 TB/s of HBM3 and 132 SMs (data sheet); shared memory
    # per block tuning.SMEM_PER_BLOCK; the launch is the 6.4 us of
    # cudaLaunchKernel per fuse-1 chase cycle, measured by chip_smoke.py's
    # stage2_profile on an H100 80GB HBM3 at 700 W (PERF.md section 5)
    "nvidia h100": DeviceProfile("nvidia h100", mem_bw=3.35e12,
                                 launch_overhead_s=6.4e-6,
                                 fast_mem_bytes=tuning.SMEM_PER_BLOCK,
                                 execution_units=132),
    # another CUDA card: the reference's generic GPU row
    "gpu": DeviceProfile("gpu", mem_bw=1.0e12, launch_overhead_s=5e-6,
                         fast_mem_bytes=32 * 2 ** 20, execution_units=64),
    # the CPU (plain versions): the reference's row
    "cpu": DeviceProfile("cpu", mem_bw=2.0e10, launch_overhead_s=250e-6,
                         fast_mem_bytes=32 * 2 ** 20, execution_units=1),
}


def device_kind(device="cuda") -> str:
    """Cache-key identity of ``device``: the card's name in lower case
    (``torch.cuda.get_device_name``) on a CUDA device, "cpu" on the CPU."""
    from repro_torch.kernels import ops      # deferred: ops imports tuning
    dev = ops.check_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev).lower()
    return dev.type


def profile_for(kind: str) -> DeviceProfile:
    """The profile of a device kind (a prefix match either way: "nvidia h100
    80gb hbm3" hits the H100 row); another CUDA card gets the "gpu" row,
    anything else the "cpu" row."""
    norm = kind.lower()
    for name, prof in PROFILES.items():
        if norm.startswith(name) or name.startswith(norm):
            return prof
    if any(tag in norm for tag in ("gpu", "cuda", "nvidia")):
        return PROFILES["gpu"]
    return PROFILES["cpu"]


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def total_chase_cycles(n: int, b_in: int, tw: int) -> int:
    """Chase cycles of one stage, whatever the fuse depth: sweep R runs
    local cycles 0..j_max(R), ``j_max = (n-1-R-b_out)//b_in``."""
    b_out = b_in - tw
    return sum((n - 1 - r - b_out) // b_in + 1
               for r in range(max(n - 1 - b_out, 0)))


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """One predicted cost, decomposed for the validation table."""
    seconds: float                  # the batched call (inf: infeasible)
    mem_seconds: float
    launch_seconds: float
    bytes_moved: float
    cycles: int
    supercycles: int                # launches
    wavefront: int                  # concurrent windows per matrix (G)
    occupancy: float                # Eq.-1 utilisation in [1/eu, 1]
    smem_bytes: int                 # working set against the budget
    feasible: bool


def _itemsize(dtype) -> int:
    return tuning.dtype_of(dtype).itemsize


def stage_cost(n: int, b_in: int, tw: int, *, fuse: int = 1, batch: int = 1,
               dtype=torch.float32, profile: DeviceProfile | None = None,
               tape: bool = False) -> CostBreakdown:
    """Predicted seconds of ONE batched stage ``b_in -> b_in - tw`` at fuse
    depth ``fuse``; ``inf`` where the working set misses the budget.
    ``profile`` defaults to the card's."""
    prof = profile if profile is not None else profile_for(device_kind())
    if not (1 <= tw <= b_in - 1 or b_in == 1) or fuse < 1 or batch < 1:
        raise ValueError(f"bad candidate b_in={b_in} tw={tw} fuse={fuse} "
                         f"batch={batch}")
    s = _itemsize(dtype)
    h = b_in + 2 * tw + 1
    wk = fuse * b_in + tw + 1
    cycles = total_chase_cycles(n, b_in, tw)
    _, supercycles, g = bc.stage_schedule(n, b_in, tw, fuse)
    smem = tuning.smem_bytes(b_in, tw, dtype, fuse)
    feasible = smem <= prof.fast_mem_bytes
    words_per_cycle = 2.0 * h * wk / fuse
    if tape:
        words_per_cycle += 2.0 * (tw + 2)      # (v, tau) pair per cycle
    bytes_moved = batch * cycles * words_per_cycle * s
    occupancy = min(1.0, batch * max(g, 1) / prof.execution_units)
    occupancy = max(occupancy, 1.0 / prof.execution_units)
    t_mem = bytes_moved / (prof.mem_bw * occupancy)
    t_launch = supercycles * prof.launch_overhead_s
    total = (t_mem + t_launch) if feasible else math.inf
    return CostBreakdown(seconds=total, mem_seconds=t_mem,
                         launch_seconds=t_launch, bytes_moved=bytes_moved,
                         cycles=cycles, supercycles=supercycles, wavefront=g,
                         occupancy=occupancy, smem_bytes=smem,
                         feasible=feasible)


def pipeline_cost(n: int, bw: int, tw: int, *, fuse: int = 1, batch: int = 1,
                  dtype=torch.float32, profile: DeviceProfile | None = None,
                  tape: bool = False) -> float:
    """Predicted seconds of the whole stage 2, ``bw -> 1``: the sum over
    ``tuning.stage_plan(bw, tw)``; ``inf`` once a stage is infeasible."""
    total = 0.0
    for b_in, twi in tuning.stage_plan(bw, tw):
        c = stage_cost(n, b_in, twi, fuse=fuse, batch=batch, dtype=dtype,
                       profile=profile, tape=tape)
        if not c.feasible:
            return math.inf
        total += c.seconds
    return total


# ---------------------------------------------------------------------------
# Fused small-n tier
# ---------------------------------------------------------------------------

# Fast-memory streaming advantage of the fused kernel's in-place reflector
# applies over device memory (the reference's coarse constant).
FUSED_FAST_BW_RATIO = 8.0


def fused_cost(n: int, bw: int, *, batch: int = 1, dtype=torch.float32,
               profile: DeviceProfile | None = None,
               compute_uv: bool = False) -> CostBreakdown:
    """Predicted seconds of ONE fused launch over a (B, n, n) stack: one
    launch, the stack in and the results out once, the reflector work from
    fast memory at ``FUSED_FAST_BW_RATIO * mem_bw``; infeasible where the
    fused kernel's scratch misses the budget (``check_fused_smem_budget``)."""
    prof = profile if profile is not None else profile_for(device_kind())
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    s = _itemsize(dtype)
    bw_eff = max(1, min(bw, max(n - 1, 1)))
    smem = tuning.fused_smem_bytes(n, dtype, bw=bw_eff, compute_uv=compute_uv)
    feasible = smem <= prof.fast_mem_bytes
    cyc2 = (total_chase_cycles(n, bw_eff, bw_eff - 1)
            if bw_eff >= 2 and n >= 3 else 0)
    cycles = max(n - 1, 0) + cyc2
    io_words = n * n + n + (2 * n * n + 2 * n if compute_uv else 0)
    bytes_moved = float(batch) * io_words * s
    work_words = cycles * 6.0 * n * n * (3.0 if compute_uv else 1.0)
    if not compute_uv:
        max_iter = 60 if s == 8 else 40
        work_words += max_iter * (2.0 * n) * (2.0 * n)   # Sturm bisection
    par = max(1.0, min(float(batch), float(prof.execution_units)))
    occupancy = max(min(1.0, batch / prof.execution_units),
                    1.0 / prof.execution_units)
    t_mem = bytes_moved / prof.mem_bw
    t_compute = (batch * work_words * s
                 / (FUSED_FAST_BW_RATIO * prof.mem_bw) / par)
    t_launch = prof.launch_overhead_s
    total = (t_mem + t_compute + t_launch) if feasible else math.inf
    return CostBreakdown(seconds=total, mem_seconds=t_mem + t_compute,
                         launch_seconds=t_launch, bytes_moved=bytes_moved,
                         cycles=cycles, supercycles=1, wavefront=1,
                         occupancy=occupancy, smem_bytes=smem,
                         feasible=feasible)


def predicted_crossover(bw: int, *, dtype=torch.float32, batch: int = 8,
                        profile: DeviceProfile | None = None,
                        compute_uv: bool = False,
                        ns: tuple[int, ...] = (8, 16, 24, 32, 48, 64, 96,
                                               128, 192, 256, 384, 512, 768,
                                               1024)) -> int:
    """Model-predicted fused-vs-staged crossover: the largest n in ``ns``
    where the fused tier's cost beats the staged stage 2's (0: never)."""
    prof = profile if profile is not None else profile_for(device_kind())
    best = 0
    for n in sorted(ns):
        bw_eff = max(1, min(bw, max(n - 1, 1)))
        fc = fused_cost(n, bw_eff, batch=batch, dtype=dtype, profile=prof,
                        compute_uv=compute_uv)
        if not fc.feasible:
            break
        tw = max(1, min(tuning.default_tilewidth(bw_eff, dtype),
                        max(bw_eff - 1, 1)))
        staged = pipeline_cost(n, bw_eff, tw, fuse=1, batch=batch,
                               dtype=dtype, profile=prof, tape=compute_uv)
        if fc.seconds < staged:
            best = n
    return best


# ---------------------------------------------------------------------------
# Stage-3 solver
# ---------------------------------------------------------------------------

# Share of a merge's poles that stay active after deflation (coarse: the
# measured search overrides the prediction).
DC_DEFLATION_FACTOR = 0.35

# Full-width secular passes per merge (the midpoint pass and a few polish
# passes).
_DC_FULL_PASSES = 6.0

# Streaming passes of one merge level over the padded problem.
_DC_LEVEL_PASSES = 64.0

# Fixed word-equivalent cost per merge level (the latency-bound parts:
# the Givens scan, top-k, sorts), the reference's calibration.
_DC_LEVEL_FLOOR_WORDS = 5.0e7


def stage3_cost(n: int, *, solver: str, dtype=torch.float64, batch: int = 1,
                profile: DeviceProfile | None = None, leaf_n: int = 32,
                newton_iters: int = 30) -> CostBreakdown:
    """Predicted seconds of ONE batched stage-3 solve, ``solver`` "bisect"
    (``max_iter * m^2`` words, m = 2n) or "dc" (the leaves' bisection, the
    merges' full passes scaled by the squared survival fraction, the
    windowed iterations and a per-level floor), streamed from fast memory
    at ``FUSED_FAST_BW_RATIO * mem_bw``, plus one launch."""
    prof = profile if profile is not None else profile_for(device_kind())
    if solver not in ("bisect", "dc") or batch < 1:
        raise ValueError(f"bad solver {solver!r} or batch {batch}")
    s = _itemsize(dtype)
    max_iter = 60 if s == 8 else 40
    m = max(2 * n, 1)
    if solver == "bisect":
        words = float(max_iter) * m * m
        smem = 4 * m * s
    else:
        lm = max(1, min(2 * leaf_n, m))
        levels = 0
        big = lm
        while big < m:
            big *= 2
            levels += 1
        words = float(max_iter) * lm * big                  # leaf bisection
        alive = DC_DEFLATION_FACTOR * DC_DEFLATION_FACTOR
        words += 2.0 * _DC_FULL_PASSES * alive * big * big
        # windowed iterations: K = 128 index-nearest + 32 heavy poles/root
        words += 2.0 * newton_iters * 160.0 * DC_DEFLATION_FACTOR * big
        words += levels * (_DC_LEVEL_PASSES * big + _DC_LEVEL_FLOOR_WORDS)
        smem = 3 * big * big * s
    occupancy = max(min(1.0, batch / prof.execution_units),
                    1.0 / prof.execution_units)
    bytes_moved = batch * words * s
    t_mem = bytes_moved / (FUSED_FAST_BW_RATIO * prof.mem_bw) / max(
        1.0, min(float(batch), float(prof.execution_units)))
    t_launch = prof.launch_overhead_s
    return CostBreakdown(seconds=t_mem + t_launch, mem_seconds=t_mem,
                         launch_seconds=t_launch, bytes_moved=bytes_moved,
                         cycles=(max_iter if solver == "bisect"
                                 else newton_iters),
                         supercycles=1, wavefront=1, occupancy=occupancy,
                         smem_bytes=smem, feasible=True)


def predicted_stage3_crossover(*, dtype=torch.float64, batch: int = 1,
                               profile: DeviceProfile | None = None,
                               leaf_n: int = 32,
                               ns: tuple[int, ...] = (128, 256, 512, 1024,
                                                      2048, 4096, 8192)
                               ) -> int:
    """Model-predicted bisect-vs-dc crossover: the smallest n in ``ns`` from
    which dc stays cheaper for every larger n; ``1 + max(ns)`` when dc
    never wins (a threshold beyond every n probed, so "auto" keeps
    bisection)."""
    prof = profile if profile is not None else profile_for(device_kind())
    probe = sorted(set(int(x) for x in ns if x >= 1))
    best = 1 + (max(probe) if probe else 0)
    for n in reversed(probe):
        dc = stage3_cost(n, solver="dc", dtype=dtype, batch=batch,
                         profile=prof, leaf_n=leaf_n)
        bi = stage3_cost(n, solver="bisect", dtype=dtype, batch=batch,
                         profile=prof, leaf_n=leaf_n)
        if dc.seconds < bi.seconds:
            best = n
        else:
            break
    return best
