"""Schedule knobs and the shared-memory budget of the Hopper chase kernels.

The paper's dominant knob is the inner tilewidth TW, whose optimum fills one
128-byte cache line (32 for fp32, 16 for fp64).  The schedule half of the
reference's ``core/tuning.py`` is copied here unchanged (``stage_plan``,
``sweep_separation``, ``max_concurrent_sweeps``): it is integer algebra and
must agree exactly.  The TPU's VMEM budget is NOT copied.  In its place
``smem_bytes`` counts the bytes the CUDA chase kernels
(``kernels/csrc/chase.cu``) hold in shared memory per block; it is the one
copy of that layout's size, and the kernels' wrappers launch with exactly
this many bytes.  ``check_smem_budget`` holds them to Hopper's 232,448 B per
block.  ``fused_route`` does the same for the fused small-n kernel
(``kernels/csrc/fused_small.cu``): it picks the kernel's route and lays
out its shared memory.  ``dc_leaf_smem_bytes`` counts the shared memory
of one block of the divide-and-conquer leaf kernel (``kernels/csrc/dc.cu``).
``default_bucket_batch`` sizes a serving bucket from the card's SMs and
the chase kernels' blocks per SM; ``DEFAULT_FUSED_CROSSOVER`` is the
largest n a serving bucket sends to the fused tier.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.householder import acc_dtype

__all__ = [
    "SMEM_PER_BLOCK", "default_tilewidth", "sweep_separation",
    "max_concurrent_sweeps", "check_disjoint_blocks", "smem_bytes",
    "check_smem_budget", "band_padding", "cycle_tile",
    "FUSED_THREADS", "FusedRoute", "fused_route", "fused_smem_bytes",
    "check_fused_smem_budget", "default_fuse_depth",
    "DEFAULT_DC_LEAF_N", "DEFAULT_DC_N_MIN", "DC_WINDOW_K", "DC_HEAVY_K",
    "DC_POLISH_ITERS", "DC_FALLBACK_ITERS", "DC_DEFLATE_CHUNK",
    "DC_DEFLATE_THREADS", "dc_deflate_schedule", "DC_MERGE_BLOCK_BYTES",
    "DC_LEAF_THREADS", "dc_leaf_smem_bytes",
    "check_dc_leaf_budget", "SMS", "SMEM_PER_SM", "CHASE_THREADS",
    "default_bucket_batch", "DEFAULT_FUSED_CROSSOVER",
    "stage_plan", "STAGE3_CHOICES", "PipelineConfig",
]

SMEM_PER_BLOCK = 232_448     # H100: shared memory one block may hold, bytes
SMEM_PER_SM = 233_472        # H100: shared memory of one SM, bytes
SMS = 132                    # H100 SXM: streaming multiprocessors
THREADS_PER_SM = 2048        # H100: resident threads of one SM
CHASE_THREADS = 512          # threads of a chase block (chase.cu kThreads)

# Serving buckets with n up to this go to the fused small-n tier
# (``backend="fused_small"``): the smaller of the two fused-vs-staged
# crossovers measured on an NVIDIA H100 80GB HBM3, power limit 700.00 W,
# by chip_smoke.py's autotune_serving phase (search_fused_crossover, batch
# 8, n = 16 ... 512): at (bw 8, fp64) and at (bw 32, fp32) the fused tier
# won at every n, 11x and 17x at n = 512, so both read 512, the sweep's
# top; with U, Sigma, V^T at (bw 32, fp64) it read 512 too (1.9x), so the
# one value serves both kinds of bucket.  Where the tiers cross above 512
# is not measured.  The reference's value is 256.
DEFAULT_FUSED_CROSSOVER = 512

# Divide and conquer (core/bidiag_dc.py and its kernels, kernels/csrc/dc.cu).
# Bidiagonals of DEFAULT_DC_LEAF_N or fewer rows are solved by bisection;
# inside the recursion it is the leaf width (GK leaves of 2 * leaf_n rows).
DEFAULT_DC_LEAF_N = 32
# stage3="auto" takes dc from this n up: the stage-3 crossover measured on
# an NVIDIA H100 80GB HBM3, power limit 700.00 W, by chip_smoke.py's
# autotune phase (search_stage3_crossover on the bidiagonals stage 2 makes
# of banded bw-64 inputs; fp64 and fp32, B = 1 to n = 16384 and B = 4 to
# 4096).  dc lost to bisection at every n, so this is the sentinel
# 1 + max(ns) and "auto" keeps bisection; with the scan in chunks, one
# division a pole and the merge's passes in blocks by bytes it still
# loses, 1.4x at fp64 n = 4096 and 1.5x / 1.8x at fp64 / fp32 n = 16384.
# On i.i.d. normal bidiagonals, the reference's sweep input, which deflate
# far more, dc wins from 4096; the reference's own 2048 was measured on a
# CPU.
DEFAULT_DC_N_MIN = 16385
# Index-nearest poles of each secular root's window in the windowed
# iteration (dc.cu's kWin, the window a warp holds in registers).
DC_WINDOW_K = 128
# The heaviest poles, added to every root's window (one a lane of dc.cu's
# warp): GK eigenvectors of random bidiagonals localise, so an index-far pole
# can carry O(1) of the rank-one weight, which the far field cannot hold.
DC_HEAVY_K = 32
# Cap on the exact full-width passes after the windowed iteration; a root
# stops once its residual reaches the rounding floor of its secular sum.
# The reference caps them at 12, which leaves a root of the bidiagonal of
# autotune.measure.banded_input(2048, 64) (fp64, seed 0) short of its floor:
# sigma 3.3e-8 * sigma_max off bisection (chip_smoke.py's crossover at that
# cap).  64 lets the bracket's bisection fallback alone reach the rounding
# floor of fp64's 53 bits from any bracket.
DC_POLISH_ITERS = 64
# Inverse-iteration steps of a leaf's collapse fallback.  Where inverse
# iteration gives two vectors of a cluster one direction, the reference puts
# the unit vector e_k, projected off the earlier ones, in the second's
# place: a vector across the whole spectrum, paired with lam_k.  On the
# bidiagonals of banded_input(512, 64, batch=4) (fp64, seed 0; their tail
# singular values are ~1e-17) that leaves sigma 2.4e-11 * sigma_max off
# bisection at leaf_n 32 (chip_smoke.py's crossover).  Two steps at lam_k,
# each projected again, bring the fallback into lam_k's invariant
# subspace; one step is not enough.
DC_FALLBACK_ITERS = 2
# The Givens scan's chunks (dc.cu's dc_deflate_kernel): one block a
# subproblem, one thread a chunk of at least DC_DEFLATE_CHUNK steps, at
# most DC_DEFLATE_THREADS threads (dc.cu's kDeflateThreads), so the
# speculative run of a chunk is 16 steps long at the top merge level of an
# n = 4096 bidiagonal (m = 8192) and 64 at n = 16384.
DC_DEFLATE_CHUNK = 16
DC_DEFLATE_THREADS = 512
# Most threads of a leaf block (dc.cu's kLeafThreads): the leaf's lm
# indices bisect over 2^s lanes each, lm 2^s <= this (dc.leaf_schedule).
# 512 leave a thread 128 registers for the Gram-Schmidt's rounds: at 1024
# (64 registers, spills) the kernel read 0.494 ms against 0.427 at fp64 n =
# 4096 on an H100 80GB HBM3 (700 W; chip_smoke.py --dc-times).
DC_LEAF_THREADS = 512
# Bytes of one (P, rows, nact) temporary of the merge's Loewner product and
# f/l rows (core/bidiag_dc.py): each pass sums over the whole active prefix
# at once and splits only its target axis, into blocks of as many rows as
# this allows.  256 MiB holds the level below the top of an fp64 n = 4096
# call (2 x 4096 x 4096 x 8 bytes) in one block; a pass makes about ten
# such temporaries, and a dc call took 1.5 GiB above its inputs at fp64
# n = 4096 and 2.1 GiB at fp32 n = 16384 (chip_smoke.py's stage3_dc on
# an H100 80GB HBM3, 700 W), of the card's 80 GB.
DC_MERGE_BLOCK_BYTES = 256 << 20

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def dc_deflate_schedule(m: int, last: int) -> tuple[int, int]:
    """(threads, chunk) of ``dc_deflate_kernel`` on a subproblem of m
    columns whose last active column is ``last``: the threads its launch
    gives m, and the steps of each chunk (steps 1 ... last in chunks of
    ``chunk``, the last one shorter)."""
    want = -(-max(m - 1, 0) // DC_DEFLATE_CHUNK)
    threads = min(DC_DEFLATE_THREADS, max(32, -(-want // 32) * 32))
    return threads, max(DC_DEFLATE_CHUNK, -(-max(last, 0) // threads))


def dtype_of(name) -> torch.dtype:
    """torch dtype from a name ("float32") or a dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    return str(dtype_of(dtype)).removeprefix("torch.")


def _itemsize(dtype) -> int:
    return dtype_of(dtype).itemsize


def default_tilewidth(bw: int, dtype=torch.float32) -> int:
    """TW that fills one 128-byte cache line (paper Fig. 4): fp32 -> 32,
    fp64 -> 16, bf16 -> 64; at least 8, at most bw - 1."""
    per_line = 128 // _itemsize(dtype)
    tw = max(8, min(per_line, 64))
    return max(1, min(tw, bw - 1))


def sweep_separation(fuse: int = 1) -> int:
    """Sweep-start separation in (super-)cycles: 3 at K = 1 (the paper's
    3-cycle rule), 2 for K >= 2, which already keeps the wider fused windows
    disjoint (``2*K*b_in - 1 >= K*b_in + tw + 1`` whenever ``K >= 2``)."""
    assert fuse >= 1, fuse
    return 3 if fuse == 1 else 2


def max_concurrent_sweeps(n: int, b_in: int, fuse: int = 1,
                          tw: int | None = None) -> int:
    """Wavefront width G (paper: #blocks) of one stage.

    ``fuse=1``: ``ceil(n / (3*b_in - 1)) + 1``.  Fused: a sweep lives
    ``dur = ceil((j_max + 1)/K)`` super-cycles, so slot ``g`` never exceeds
    ``(dur - 1) // sep``; that bound needs ``tw``."""
    if fuse == 1 or tw is None:
        stride = sweep_separation(fuse) * fuse * b_in - 1
        return max(1, -(-n // stride) + 1)
    j_max0 = max((n - 1 - (b_in - tw)) // b_in, 0)
    dur0 = -(-(j_max0 + 1) // fuse)
    return max(1, (dur0 - 1) // sweep_separation(fuse) + 1)


def default_bucket_batch(n: int, b_in: int, dtype=torch.float32) -> int:
    """Matrices a serving bucket batches so that one chase launch fills
    the card (paper Eq. 1): the H100 counterpart of the reference's
    ``default_bucket_batch``.

    A fuse-1 chase launch runs one block per live slot: ``G =
    max_concurrent_sweeps(n, b_in)`` for one matrix, B*G for a batch of B.
    The card holds ``SMS`` (132) SMs, each of them as many chase blocks as
    both its resident threads (2048 over ``CHASE_THREADS`` = 512: 4) and
    its shared memory (``SMEM_PER_SM`` over ``smem_bytes`` of the stage
    at the cache-line tilewidth, plus the 1 KB the runtime keeps per
    block) allow.  B is the smallest batch whose B*G blocks fill every
    such place at once, ``ceil(SMS * blocks_per_sm / G)``, clamped to [1,
    64]: a matrix whose own wavefront fills the card gets 1.  The
    reference reasons from 2 execution units and 8 slots of
    oversubscription each; registers are not counted here (``ptxas -v``
    shows what each kernel holds)."""
    b_in = max(int(b_in), 1)
    tw = default_tilewidth(max(b_in, 2), dtype_of(dtype))
    per_block = smem_bytes(b_in, tw, dtype) + 1024
    blocks_per_sm = max(1, min(THREADS_PER_SM // CHASE_THREADS,
                               SMEM_PER_SM // per_block))
    per_matrix = max_concurrent_sweeps(max(int(n), 1), b_in)
    return max(1, min(64, -(-SMS * blocks_per_sm // per_matrix)))


def check_disjoint_blocks(n: int, b_in: int, tw: int, fuse: int,
                          slots: int, ncols: int) -> None:
    """Raise unless the ``slots`` blocks of one (super-)cycle, each
    ``fuse*b_in + tw + 1`` columns wide, are pairwise disjoint in a padded
    band of ``ncols`` columns, dump zones included: what a launch that
    chases them in place relies on.

    A live slot starts at a pivot column p <= n - 1, and slot g + 1 starts
    ``sweep_separation(fuse)*fuse*b_in - 1`` columns after slot g; a slot
    that is not live points at its own dump zone ``n + wk + g*wk``, which
    the padding must hold."""
    wk = fuse * b_in + tw + 1
    step = sweep_separation(fuse) * fuse * b_in - 1
    if step < wk:
        raise ValueError(
            f"slots {step} columns apart overlap in blocks {wk} wide "
            f"(b_in={b_in}, tw={tw}, fuse={fuse}): the schedule is not "
            f"race-free")
    if ncols < n + wk + slots * wk:
        raise ValueError(
            f"a padded band of {ncols} columns has no room for the dump "
            f"zones of {slots} slots past n={n} (needs {n + wk + slots * wk})")


def smem_bytes(b_in: int, tw: int, dtype=torch.float32, fuse: int = 1) -> int:
    """Shared memory one block of a chase kernel that stages panels holds,
    in bytes: the windows entry of the cycle kernel and the super-step.

    They stage the two panels a cycle changes, in the accumulation type:
    the column panel rows ``[tw, H)`` x cols ``[0, tw]`` and the part of the
    row panel (rows ``[H-1-tw, H)``) right of it, cols ``[tw+1, W)``, its
    rows padded by one word, and a copy of column 0 for the left
    reflector.  The reflectors stay in registers.  The super-step chases
    its K cycles in the same panels, carrying the corner two cycles share,
    so the count does not grow with ``fuse``."""
    assert fuse >= 1, fuse
    h = b_in + 2 * tw + 1
    panels = (h - tw) * (tw + 1) + (tw + 1) * (b_in + 1)
    words = panels + (tw + 1)
    return words * _itemsize(acc_dtype(dtype_of(dtype)))


def band_padding(n: int, b_in: int, tw: int, fuse: int, slots: int) -> int:
    """Columns of a stage's padded band: the n columns, a gap of one block
    and the dump zones of the ``slots`` slots (``fuse*b_in + tw + 1``
    columns each), rounded up to 8 columns so that a band row starts on a
    16-byte boundary in every dtype (what a TMA copy of the band needs)."""
    wk = fuse * b_in + tw + 1
    return -(-(n + wk + slots * wk) // 8) * 8


def cycle_tile(b_in: int, tw: int, dtype=torch.float32):
    """``(box_w, bytes)`` of the one-cycle band kernel (``chase.cu`` kernel
    3): it moves a slot's band rectangle, rows ``[0, H)`` x ``box_w``
    columns from the window's first column rounded down to 16 bytes, as one
    TMA box in the storage type; ``box_w`` covers W = b_in + tw + 1 columns
    from any start, W + 16 bytes - 1 element rounded up to 16 bytes, and
    ``bytes`` counts the box, a copy of column 0 in the accumulation type,
    an mbarrier and 128 bytes to align the box.  None where the kernel does
    not take the stage: a box side above TMA's 256, a box wider than the
    slots' separation of 3*b_in - 1 columns less 16 bytes (the boxes of one
    launch must not overlap), or more shared memory than a block has; the
    stage then goes through the super-step kernel at K = 1."""
    es = _itemsize(dtype)
    per = 16 // es
    box_w = -(-(b_in + tw + per) // per) * per
    h = b_in + 2 * tw + 1
    if h > 256 or box_w > 256 or box_w > 3 * b_in - per:
        return None
    x2_off = -(-(h * box_w * es) // 16) * 16
    bar_off = -(-(x2_off + (tw + 1) * _itemsize(acc_dtype(dtype_of(dtype))))
                // 8) * 8
    need = bar_off + 8 + 128
    return (box_w, need) if need <= SMEM_PER_BLOCK else None


def check_smem_budget(b_in: int, tw: int, dtype=torch.float32,
                      fuse: int = 1) -> int:
    """Raise when a chase block would not fit Hopper's shared memory;
    return the bytes it needs."""
    need = smem_bytes(b_in, tw, dtype, fuse)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"chase kernel for b_in={b_in}, tw={tw}, dtype={dtype_name(dtype)}"
            f" needs {need} B of shared memory per block; the H100 gives "
            f"{SMEM_PER_BLOCK} B. Reduce the bandwidth or the tilewidth.")
    return need


FUSED_THREADS = 512          # threads of a fused block (fused_small.cu)


@dataclasses.dataclass(frozen=True)
class FusedRoute:
    """Where one block of the fused small-n kernel keeps its working set.

    ``name`` is "smem" (phases 2 and 3 in shared memory; phase 1 moves in
    at column ``j0``, before it the trailing block is read and written in
    device memory; ``j0 >= n - 1``: never) or "global" (every phase on the
    matrix in device memory, phase 3's z and counts in shared memory).
    ``uv_smem``: U2 and V2 in shared memory too (uv mode).  The layout, in
    words of the accumulation type: ``scratch`` words (phases 1-2: partial
    sums, ``FUSED_THREADS``, and the reflector, n; phase 3 over them: z,
    two scalars and n int32 counts), then ``region`` words (the trailing
    block with row stride ``ldt``, then the band: ``h`` diagonals of
    stride ``ldb``, the first ``dlo`` below the main one), then U2 and V2
    (row stride ``ldu``) where ``uv_smem``.  Strides are odd, so a warp's
    lanes on consecutive rows of one column meet distinct banks."""
    name: str
    j0: int
    uv_smem: bool
    scratch: int
    region: int
    ldt: int
    ldb: int
    ldu: int
    dlo: int
    h: int
    smem_bytes: int


def _fused_scratch(n: int, compute_uv: bool, itemsize: int) -> int:
    words = FUSED_THREADS + n
    if not compute_uv:
        words = max(words, 2 * n + 2 + -(-4 * n // itemsize))
    return words


@functools.lru_cache(maxsize=256)
def _fused_route(n: int, bw: int, itemsize: int,
                 compute_uv: bool) -> FusedRoute:
    budget = SMEM_PER_BLOCK // itemsize
    # the values mode's scratch decides the route in both modes, so that
    # both reduce A by the same arithmetic
    x_val = _fused_scratch(n, False, itemsize)
    x = x_val if (not compute_uv or x_val <= budget) else \
        _fused_scratch(n, True, itemsize)
    dlo = min(bw - 1, n - 1)
    h = dlo + min(2 * bw - 1, n - 1) + 1
    ldb = n | 1
    band = h * ldb
    # (the kernel relies on it: in shared memory every support fits the
    # lanes of a warp, 32 x 8 entries)
    if x_val + band <= budget and bw <= 256:
        name = "smem"
        j0 = next((j for j in range(n - 1)
                   if x_val + max((n - j) * ((n - j) | 1), band) <= budget),
                  n - 1)
        ldt = (n - j0) | 1 if j0 < n - 1 else 0
        region = max((n - j0) * ldt, band)
    else:
        name, j0, ldt, region, ldb, dlo, h = "global", n - 1, 0, 0, 0, 0, 0
    ldu = n | 1
    uv_smem = compute_uv and x + region + 2 * n * ldu <= budget
    words = x + region + (2 * n * ldu if uv_smem else 0)
    return FusedRoute(name, j0, uv_smem, x, region, ldt, ldb,
                      ldu if uv_smem else 0, dlo, h, words * itemsize)


def fused_route(n: int, bw: int, dtype=torch.float32, *,
                compute_uv: bool = False) -> FusedRoute:
    """The route and shared-memory layout of the fused kernel for (n, bw)
    (bw clamped as ``ref.effective_bw``), in the accumulation type of
    ``dtype``: the "smem" route wherever the band (3bw - 1 diagonals, fewer
    where n is smaller) fits beside the scratch, phase 1 in shared memory
    from the first column whose trailing block fits there too.  The kernel
    checks the layout and the byte count it is launched with."""
    n = max(int(n), 1)
    bw = max(1, min(int(bw), max(n - 1, 1)))
    return _fused_route(n, bw, _itemsize(acc_dtype(dtype_of(dtype))),
                        bool(compute_uv))


def fused_smem_bytes(n: int, dtype=torch.float32, *, bw: int,
                     compute_uv: bool = False) -> int:
    """Dynamic shared memory of one block of the fused small-n kernel, in
    bytes: that of its route (``fused_route``)."""
    return fused_route(n, bw, dtype, compute_uv=compute_uv).smem_bytes


def check_fused_smem_budget(n: int, dtype=torch.float32, *,
                            compute_uv: bool = False) -> int:
    """Raise when the fused kernel's O(n) scratch (what even its "global"
    route keeps in shared memory) would not fit Hopper's shared memory;
    return its bytes.

    The fused tier has no tiled fallback, so such an n belongs on the
    staged pipeline."""
    itemsize = _itemsize(acc_dtype(dtype_of(dtype)))
    need = _fused_scratch(max(int(n), 1), compute_uv, itemsize) * itemsize
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_small kernel for n={n}, dtype={dtype_name(dtype)} "
            f"(compute_uv={compute_uv}) needs {need} B of shared memory per "
            f"block; the H100 gives {SMEM_PER_BLOCK} B. Route this size to "
            f"the staged pipeline instead.")
    return need


def default_fuse_depth(b_in: int, tw: int, dtype=torch.float32, *,
                       cap: int = 4) -> int:
    """Fuse depth K for ``fuse=None``: the cap, once ``check_smem_budget``
    has shown that a K-cycle block fits (the count does not grow with K, so
    shared memory never forces a shallower K).  Past K = 2 the super-cycle
    count stops falling (sweep starts set it), so the cap is small."""
    cap = max(int(cap), 1)
    check_smem_budget(b_in, tw, dtype, cap)
    return cap


def dc_leaf_smem_bytes(leaf_n: int, dtype=torch.float64) -> int:
    """Shared memory of one block of the divide-and-conquer leaf kernel
    (``dc.cu``, one block per leaf of ``lm = 2*leaf_n`` rows), in bytes: the
    eigenvectors, an lm x (lm + 1) array (column k is vector k); four words
    a row, the leaf's diagonal, off-diagonal and its squares and its
    eigenvalues; and the pivot guard, in the accumulation type; then one
    int32 a row, the counts of the bisection tree's top.  The factors of
    the inverse iteration live in a device-memory scratch
    (``kernels/dc.py``), not here."""
    lm = 2 * int(leaf_n)
    return ((lm * (lm + 1) + 4 * lm + 1) * _itemsize(acc_dtype(dtype_of(
        dtype))) + 4 * lm)


def check_dc_leaf_budget(leaf_n: int, dtype=torch.float64) -> int:
    """Raise when a leaf block of ``leaf_n`` would not fit Hopper's shared
    memory (fp64: dc_leaf_n <= 83; fp32: <= 119); return its bytes.  Its
    lm = 2 leaf_n vectors, one thread each, stay within
    ``DC_LEAF_THREADS`` wherever the memory fits."""
    need = dc_leaf_smem_bytes(leaf_n, dtype)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"dc leaf kernel for dc_leaf_n={leaf_n}, dtype={dtype_name(dtype)}"
            f" needs {need} B of shared memory per block; the H100 gives "
            f"{SMEM_PER_BLOCK} B. Use a smaller dc_leaf_n.")
    return need


def stage_plan(bw: int, tw: int) -> tuple[tuple[int, int], ...]:
    """Tile-width schedule ((b_in, tw_i), ...) reducing bw -> 1, <= tw per
    stage."""
    plan = []
    b = bw
    while b > 1:
        twi = min(tw, b - 1)
        plan.append((b, twi))
        b -= twi
    return tuple(plan)


STAGE3_CHOICES = ("bisect", "dc", "auto")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Resolved configuration of the pipeline (stages 1 to 3).

    ``backend`` is "ref" (plain PyTorch), "cuda" (the hand-written
    kernels) or "fused_small" (the one-launch small-n tier: the fused
    kernel on a CUDA device, its plain version on the CPU); ``device`` is
    where the pipeline runs, the card unless the caller asks for the CPU;
    ``compute_uv`` is the default of ``svd_batched``: singular vectors too
    (the tapes are recorded and replayed).  ``stage3`` is the bidiagonal
    solver, "bisect" (Sturm bisection), "dc" (divide and conquer,
    ``core/bidiag_dc.py``, leaves of ``dc_leaf_n``) or "auto" (dc from
    ``dc_n_min`` up, collapsed by :meth:`stage3_for`).  ``max_batch`` is a
    serving bucket's capacity: the serve engines pad every dispatch of a
    bucket to it; nothing else reads it."""
    bw: int
    tw: int
    backend: str = "cuda"
    dtype: str = "float32"
    fuse: int = 1
    stage3: str = "bisect"
    device: str = "cuda"
    compute_uv: bool = False
    dc_leaf_n: int = DEFAULT_DC_LEAF_N
    dc_n_min: int = DEFAULT_DC_N_MIN
    max_batch: int = 8

    @property
    def plan(self) -> tuple[tuple[int, int], ...]:
        return stage_plan(self.bw, self.tw)

    def stage3_for(self, n: int) -> str:
        """The stage-3 solver for a problem of size n: "auto" (left by a
        resolve that did not know n) is "dc" from ``dc_n_min`` up, else
        "bisect"; an explicit choice passes through."""
        if self.stage3 != "auto":
            return self.stage3
        return "dc" if n >= self.dc_n_min else "bisect"

    @classmethod
    def resolve(cls, *, bw: int = 32, tw: int | None = None,
                backend: str = "auto", dtype=torch.float32,
                n: int | None = None, fuse: int | None = 1,
                stage3: str = "bisect", device: str = "cuda",
                compute_uv: bool = False, autotune: bool = False,
                autotune_cache: str | None = None,
                dc_leaf_n: int | None = None,
                dc_n_min: int | None = None,
                max_batch: int | None = None) -> "PipelineConfig":
        """Resolve every knob to a concrete value.

        ``backend="auto"`` follows the requested ``device``: "cuda" on a
        CUDA device, "ref" on the CPU.  It never looks at what the machine
        has.  ``fuse=None`` asks ``default_fuse_depth``.  With
        ``backend="fused_small"`` and a known ``n``, an n whose fused block
        would not fit shared memory raises (``check_fused_smem_budget``).

        ``autotune=True`` reads the tuned-config cache
        (``repro_torch.autotune.cache``; ``autotune_cache`` is its path,
        else ``$REPRO_TORCH_AUTOTUNE_CACHE`` or the default): with ``n``
        known, the entry for (device kind, n, bw, dtype, compute_uv, the
        resolved backend) gives ``tw`` where it is None and ``fuse`` where
        it is None or 1 and ``max_batch`` where it is None (where the
        search explored the batch axis), and ``lookup_stage3`` gives
        ``dc_n_min`` where it is None.  Explicit values win; a miss keeps
        the analytic defaults.  ``max_batch=None`` is otherwise
        ``default_bucket_batch(n, bw)``, or 8 where n is not known.

        ``stage3`` is "bisect", "dc" or "auto" (another value raises
        ``ValueError``); with ``n`` known "auto" collapses here.
        ``dc_leaf_n=None`` is ``DEFAULT_DC_LEAF_N``, ``dc_n_min=None`` the
        cache's reading or ``DEFAULT_DC_N_MIN``.  On a CUDA device a
        ``dc_leaf_n`` whose leaf block would not fit shared memory raises
        (``check_dc_leaf_budget``)."""
        from repro_torch.kernels import ops   # deferred: ops imports tuning
        if stage3 not in STAGE3_CHOICES:
            raise ValueError(f"stage3 must be one of {STAGE3_CHOICES}, got "
                             f"{stage3!r}")
        bw = max(int(bw), 1)
        if n is not None:
            bw = min(bw, max(n, 1))
        backend = ops.resolve_backend(backend, device)
        if autotune:
            from repro_torch.autotune import cache as at_cache
            from repro_torch.autotune import model as at_model
            kind = at_model.device_kind(device)
            if n is not None:
                tuned = at_cache.lookup(
                    device_kind=kind, n=n, bw=bw, dtype=dtype_name(dtype),
                    compute_uv=compute_uv, backend=backend,
                    path=autotune_cache)
                if tuned is not None:
                    tw = tw if tw is not None else tuned["tw"]
                    fuse = fuse if fuse not in (None, 1) else tuned["fuse"]
                    if max_batch is None:
                        max_batch = tuned.get("max_batch")
            if dc_n_min is None:
                dc_n_min = at_cache.lookup_stage3(
                    device_kind=kind, dtype=dtype_name(dtype),
                    compute_uv=compute_uv, path=autotune_cache)
        tw = tw if tw is not None else default_tilewidth(bw, dtype_of(dtype))
        tw = max(1, min(tw, max(bw - 1, 1)))
        check_smem_budget(bw, tw, dtype)
        if backend == "fused_small" and n is not None:
            check_fused_smem_budget(n, dtype, compute_uv=compute_uv)
        if fuse is None:
            fuse = default_fuse_depth(bw, tw, dtype)
        if max_batch is None:
            max_batch = default_bucket_batch(n, bw, dtype) if n else 8
        dc_leaf_n = max(int(dc_leaf_n if dc_leaf_n is not None
                            else DEFAULT_DC_LEAF_N), 1)
        dc_n_min = max(int(dc_n_min if dc_n_min is not None
                           else DEFAULT_DC_N_MIN), 1)
        if stage3 == "auto" and n is not None:
            stage3 = "dc" if n >= dc_n_min else "bisect"
        if stage3 != "bisect" and torch.device(device).type == "cuda":
            check_dc_leaf_budget(dc_leaf_n, dtype)
        return cls(bw=bw, tw=tw, backend=backend, dtype=dtype_name(dtype),
                   fuse=max(int(fuse), 1), stage3=stage3, device=str(device),
                   compute_uv=bool(compute_uv), dc_leaf_n=dc_leaf_n,
                   dc_n_min=dc_n_min, max_batch=max(int(max_batch), 1))
