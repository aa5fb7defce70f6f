"""The port's CUDA kernels against their plain versions, on a card.

Tests marked ``cuda`` skip where there is no CUDA device.  This file imports
no JAX, so it runs on a machine with a card and no JAX, without the
repository's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances are the reference's kernel-test ones (fp32 3e-5, fp64 1e-12,
bf16 8e-2, times the output's scale); the compact-WY apply's are fp32 and
fp64 times max(1, k // 4) as well, and bf16 1e-2 times the scale, about one
bf16 ulp (``wy_tol``); bisection agrees to 1e-13 * sigma_max at fp64 and
1e-5 * sigma_max at fp32; the divide-and-conquer kernels: leaf eigenvalues
and the deflation scan bit for bit, the secular roots within 1e-13 (fp64)
or 1e-5 (fp32) of the pole scale; causal flash attention, both kernels,
with k and v of BH or BH / g rows, each query row to its own size
(``flash_attention.row_error`` within ``flash_attention.CHECK_TOLS``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port_common import (DTYPES, close, cuda, torch_dtype,  # noqa: F401
                               windows, wy_tol)

from repro_torch.core import bidiag_dc as tdc
from repro_torch.core import bidiag_svd as s3
from repro_torch.core import svd as tsvd
from repro_torch.core import tuning
from repro_torch.core.tuning import PipelineConfig, stage_plan
from repro_torch.kernels import bisect as tbisect
from repro_torch.kernels import bulge_chase as tkern
from repro_torch.kernels import dc as tdc_kern
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import fused_small as tfused
from repro_torch.kernels import hh_apply as thh
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

CHASE_SHAPES = [(4, 2, 3), (6, 2, 4), (8, 3, 5), (12, 4, 3), (16, 8, 2),
                (32, 8, 2), (5, 4, 6), (2, 1, 8)]
SUPER_SHAPES = [(4, 2, 3), (8, 3, 4), (5, 4, 3)]
FUSES = [2, 4]
# (m, k, w) of the reference's compact-WY tests (tests/test_kernels.py)
WY_SHAPES = [(64, 8, 100), (128, 16, 64), (33, 4, 7), (256, 32, 512),
             (16, 1, 5)]
# the fused kernel: the reference's shapes and the two main-path runs of
# chip_smoke.py, held to fused_small's CHECK_TOLS and ENTRY_TOL_FP64
FUSED_SHAPES = tfused.CHECK_SHAPES + [(64, 64, 8), (64, 256, 32)]
# each route of the fused kernel (tuning.fused_route), with what it keeps in
# shared memory: (B, n, bw, dtype, route, j0, uv_smem)
FUSED_ROUTE_CASES = [
    (3, 64, 8, "float64", "smem", 0, True),       # all of it, U2 and V2 too
    (2, 256, 32, "float32", "smem", 17, False),   # phase 1 moves in at 17
    (2, 256, 40, "float64", "global", 255, False),
    (2, 300, 4, "float64", "smem", 133, False),    # supports past 256
    (2, 300, 8, "float32", "smem", 61, False)]


def wy_inputs(s, m, k, w, seed, dtype, device):
    """A unit-lower-trapezoidal V, an upper-triangular T (scaled by 0.2) and
    a C per slot, as the reference's kernel test makes them."""
    rng = np.random.default_rng(seed)
    v = np.tril(rng.standard_normal((s, m, k)), -1)
    d = min(m, k)
    v[:, np.arange(d), np.arange(d)] = 1.0
    t = np.triu(rng.standard_normal((s, k, k))) * 0.2
    c = rng.standard_normal((s, m, w))
    return tuple(torch.from_numpy(x).to(device, dtype) for x in (v, t, c))


def _gk(n, b, seed, dtype, device):
    """Prescaled Golub-Kahan inputs (z, bound) of b random bidiagonals."""
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(rng.standard_normal((b, n))).to(device, dtype)
    e = torch.from_numpy(rng.standard_normal((b, n))).to(device, dtype)
    return s3.gk_problem(d, e)[:2]


# ---------------------------------------------------------------------------
# On the CPU the wrappers run the plain versions
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    """``ops`` sends CPU tensors to the plain versions; the kernels' own
    wrappers take CUDA tensors only and raise on anything else."""
    x, first = windows(8, 3, 4, 1)
    win = torch.from_numpy(x)
    tf = torch.from_numpy(first)
    before = ops.launch_counts()
    want = tref.chase_cycle_ref(win, tf, b_in=8, tw=3)
    got = ops.chase_cycle(win.clone(), tf, b_in=8, tw=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.chase_cycle_cuda(win.clone(), tf, b_in=8, tw=3)
    blocks = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 15, 2 * 8 + 4)))
    act = torch.ones(3, 2, dtype=torch.bool)
    want = tref.chase_superstep_ref(blocks, tf[:3], act, b_in=8, tw=3, fuse=2)
    got = ops.chase_cycle(blocks.clone(), tf[:3], b_in=8, tw=3, fuse=2,
                          active=act)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.chase_superstep_cuda(blocks.clone(), tf[:3], act, b_in=8, tw=3,
                                   fuse=2)
    z, bound = _gk(9, 2, 3, torch.float64, "cpu")
    torch.testing.assert_close(
        ops.sturm_bisect(z, bound, n=9, max_iter=60),
        s3.bisect_plain(z, bound, n=9, max_iter=60), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tbisect.sturm_bisect_cuda(z, bound, n=9, max_iter=60)
    v, t, c = wy_inputs(3, 20, 4, 9, 4, torch.float64, "cpu")
    torch.testing.assert_close(ops.tape_apply(v, t, c),
                               tref.tape_apply_ref(v, t, c), rtol=0, atol=0)
    torch.testing.assert_close(ops.hh_block_apply(v[0], t[0], c[0]),
                               tref.hh_block_apply_ref(v[0], t[0], c[0]),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.hh_block_apply(v, t, c),
                               tref.tape_apply_ref(v, t, c), rtol=0, atol=0)
    assert ops.launch_counts() == before      # no kernel ran


def test_fused_small_wrapper_takes_cuda_tensors_only():
    """On the CPU ``ops.fused_svd`` runs the plain version and launches
    nothing; the kernel's wrapper raises on a CPU tensor."""
    a = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9, 9)))
    before = ops.launch_counts()
    torch.testing.assert_close(ops.fused_svd(a, bw=3),
                               tref.fused_small_svd_ref(a, bw=3),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.fused_svd(a, bw=3, backend="fused_small"),
                               tref.fused_small_svd_ref(a, bw=3),
                               rtol=0, atol=0)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_small_svd_cuda(a, bw=3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_svd(a, bw=3, backend="cuda")


def test_tape_apply_wrapper_takes_cuda_tensors_only():
    """The compact-WY wrappers raise on CPU tensors, on a k the kernel does
    not take and on mismatched operands, before any launch."""
    v, t, c = wy_inputs(2, 12, 3, 5, 0, torch.float64, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        thh.tape_apply_cuda(v, t, c)
    with pytest.raises(ValueError, match="CUDA"):
        thh.hh_block_apply_cuda(v[0], t[0], c[0])
    with pytest.raises(ValueError, match="CUDA"):
        ops.tape_apply(v, t, c, backend="cuda")
    with pytest.raises(ValueError, match="k <= 128"):
        thh.launch_shape(1, 129, 64, torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        thh.tape_apply_cuda(v, t, c.to(torch.float16))
    # the path by m and k; the large-m path's tiles and splits depend on
    # (m, k, w) only, never on the slot count
    plan = thh.launch_shape(4224, 64, 4224, torch.float64)
    assert (plan.path, plan.kernels, plan.kp, plan.nsplit) == (
        "large", 3, 64, 8)
    small = thh.launch_shape(16, 1, 4096, torch.float64)
    assert (small.path, small.kernels) == ("small", 1)
    assert thh.launch_shape(1, 128, 64, torch.float64) == thh.LaunchPlan(
        "large", 128, 1, 32, 128,
        (2 * 32 * (132 + 68) * 8, (128 * 32 + 128 * 128) * 8,
         64 * 132 * 8 + 128 * 68 * 8))


# ---------------------------------------------------------------------------
# On a card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b_in,tw,G", CHASE_SHAPES + [(64, 32, 87),
                                                      (64, 16, 40)])
def test_chase_cycle_cuda_matches_plain(cuda, b_in, tw, G, dtype, tol):
    x, first = windows(b_in, tw, G, 7 + b_in)
    win = torch.from_numpy(x).to(cuda, torch_dtype(dtype))
    tf = torch.from_numpy(first).to(cuda)
    want = tref.chase_cycle_ref(win, tf, b_in=b_in, tw=tw, with_tape=True)
    got = tkern.chase_cycle_cuda(win.clone(), tf, b_in=b_in, tw=tw,
                                 with_tape=True)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, want):
        close(g_, r_, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b_in,tw,G", SUPER_SHAPES + [(64, 32, 30)])
def test_chase_superstep_cuda_matches_plain(cuda, b_in, tw, G, dtype, tol,
                                            fuse):
    h, wk = b_in + 2 * tw + 1, fuse * b_in + tw + 1
    rng = np.random.default_rng(fuse + b_in)
    blocks = torch.from_numpy(rng.standard_normal((G, h, wk))).to(
        cuda, torch_dtype(dtype))
    first = torch.arange(G, device=cuda) % 2 == 0
    live = torch.from_numpy(rng.integers(0, fuse + 1, size=G)).to(cuda)
    active = torch.arange(fuse, device=cuda)[None, :] < live[:, None]
    kw = dict(b_in=b_in, tw=tw, fuse=fuse, with_tape=True)
    want = tref.chase_superstep_ref(blocks, first, active, **kw)
    got = tkern.chase_superstep_cuda(blocks.clone(), first, active, **kw)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, want):
        close(g_, r_, tol)


# (n, bw, tw, B) of chip_smoke.py's main-path runs at fuse 4: fp64 n = 4096
# (banded and dense), fp32 n = 16384, fp32 B = 16 n = 512, the stage-2
# profile at n = 2048 and the warm-up at n = 256; each of their stages is a
# super-step shape (b_in, tw, B*G slots, K = 4)
MAIN_FUSE4_RUNS = [(4096, 64, 16, 1), (16384, 64, 32, 1), (512, 32, 31, 16),
                   (2048, 64, 32, 1), (256, 64, 16, 1)]
MAIN_SUPER_STAGES = sorted({(n, b_in, tw, b)
                            for n, bw, tw0, b in MAIN_FUSE4_RUNS
                            for b_in, tw in stage_plan(bw, tw0)})


def _stage_tables(n, b_in, tw, fuse, b, seed, dtype, device, ragged=True):
    """A padded band (B, H, n_pad) of random values in its first n columns,
    the stage's tables (p_safe as int32) and a super-cycle t in the middle
    of the stage; with ``ragged`` row t of ``live`` gets a random prefix
    per started slot."""
    from repro_torch.core import bulge_chasing as bc
    _, T, G = bc.stage_schedule(n, b_in, tw, fuse)
    h = b_in + 2 * tw + 1
    rng = np.random.default_rng(seed)
    bandp = torch.zeros((b, h, tuning.band_padding(n, b_in, tw, fuse, G)),
                        dtype=torch.float64)
    bandp[..., :n] = torch.from_numpy(rng.standard_normal((b, h, n)))
    p_safe, first, live = bc._cycle_table(n, b_in, tw, fuse, T, G, b,
                                          device)
    t = T // 2
    if ragged:
        started = (p_safe[t] < n).cpu()
        n_live = torch.from_numpy(rng.integers(0, fuse + 1, size=G))
        live[t] = ((torch.arange(fuse)[None, :] < n_live[:, None])
                   & started[:, None]).to(device)
    return (bandp.to(device, dtype), p_safe.to(torch.int32), first, live, t)


def _tape_bufs(bandp, T, G, fuse, tw):
    b = bandp.shape[0]
    return (torch.full((b, T, G, fuse, 2, tw + 1), 7.0, dtype=bandp.dtype,
                       device=bandp.device),
            torch.full((b, T, G, fuse, 2), 7.0, dtype=bandp.dtype,
                       device=bandp.device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("n,b_in,tw,b", [(16384, 64, 32, 1),
                                         (4096, 64, 16, 1), (300, 12, 5, 3)])
def test_chase_superstep_band_matches_blocks_bitwise(cuda, n, b_in, tw, b,
                                                     dtype):
    """The band entry (blocks addressed where they lie in the padded band,
    tape written in place) and the blocks entry (blocks gathered, chased,
    scattered) are one kernel: the band, v and the live taus agree bit for
    bit, and the band entry writes tau = 0 where a cycle is not live."""
    fuse = 4
    bandp, p32, first, live, t = _stage_tables(n, b_in, tw, fuse, b, n,
                                               torch_dtype(dtype), cuda)
    T, G = p32.shape
    tape = _tape_bufs(bandp, T, G, fuse, tw)
    got = tkern.chase_superstep_band_cuda(bandp.clone(), p32, first, live, t,
                                          b_in=b_in, tw=tw, fuse=fuse,
                                          tape=tape)
    h, wk = bandp.shape[1], fuse * b_in + tw + 1
    rows = torch.arange(h, device=cuda)[:, None]
    cols = p32[t].long()[:, None, None] + torch.arange(wk, device=cuda)
    blocks = bandp[:, rows, cols].reshape(b * G, h, wk).contiguous()
    act = live[t].repeat(b, 1)
    _, vs, taus = tkern.chase_superstep_cuda(blocks, first[t].contiguous(),
                                             act, b_in=b_in, tw=tw,
                                             fuse=fuse, with_tape=True)
    want = bandp.clone()
    want[:, rows, cols] = blocks.reshape(b, G, h, wk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(tape[0][:, t], vs.reshape(b, G, fuse, 2, tw + 1))
    taus = taus.reshape(b, G, fuse, 2)
    on = act.reshape(b, G, fuse)[..., None].expand_as(taus)
    assert torch.equal(tape[1][:, t][on], taus[on])
    assert bool((tape[1][:, t][~on] == 0).all())
    assert bool((tape[0][:, :t] == 7).all() and (tape[1][:, t + 1:] == 7)
                .all())                          # other rows untouched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n,b_in,tw,b", MAIN_SUPER_STAGES)
def test_chase_superstep_entries_match_plain_at_main_shapes(cuda, n, b_in,
                                                            tw, b, dtype,
                                                            tol):
    """Both super-step entries against the plain version at every stage
    shape of the main path's fuse-4 runs, with ragged live masks: the band
    entry on a super-cycle of the real schedule (band and tape), the blocks
    entry on blocks of the same (B*G, H, WK)."""
    fuse = 4
    dt = torch_dtype(dtype)
    bandp, p32, first, live, t = _stage_tables(n, b_in, tw, fuse, b,
                                               n + b_in, dt, cuda)
    T, G = p32.shape
    tape, want_tape = (_tape_bufs(bandp, T, G, fuse, tw) for _ in "ab")
    got = tkern.chase_superstep_band_cuda(bandp.clone(), p32, first, live, t,
                                          b_in=b_in, tw=tw, fuse=fuse,
                                          tape=tape)
    want = tref.chase_superstep_band_ref(bandp.clone(), p32, first, live, t,
                                         b_in=b_in, tw=tw, fuse=fuse,
                                         tape=want_tape)
    torch.cuda.synchronize()
    close(got, want, tol)
    close(tape[0][:, t], want_tape[0][:, t], tol)
    close(tape[1][:, t], want_tape[1][:, t], tol)
    h, wk = bandp.shape[1], fuse * b_in + tw + 1
    rng = np.random.default_rng(n * b_in + tw)
    blocks = torch.from_numpy(rng.standard_normal((b * G, h, wk))).to(cuda,
                                                                      dt)
    n_live = torch.from_numpy(rng.integers(0, fuse + 1, size=b * G)).to(cuda)
    act = torch.arange(fuse, device=cuda)[None, :] < n_live[:, None]
    isf = torch.arange(b * G, device=cuda) % 3 == 0
    kw = dict(b_in=b_in, tw=tw, fuse=fuse, with_tape=True)
    want = tref.chase_superstep_ref(blocks, isf, act, **kw)
    got = tkern.chase_superstep_cuda(blocks.clone(), isf, act, **kw)
    torch.cuda.synchronize()
    for g_, r_ in zip(got, want):
        close(g_, r_, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 5])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,w", WY_SHAPES + [(17, 1, 700), (300, 64, 260),
                                               (140, 128, 40)])
def test_tape_apply_cuda_matches_plain(cuda, m, k, w, dtype, tol, slots):
    v, t, c = wy_inputs(slots, m, k, w, m + k + w, torch_dtype(dtype), cuda)
    want = tref.tape_apply_ref(v, t, c)
    before = thh.launches["tape_apply_cuda"]
    got = thh.tape_apply_cuda(v, t, c.clone())
    torch.cuda.synchronize()
    assert thh.launches["tape_apply_cuda"] == before + 1
    close(got, want, wy_tol(dtype, tol, k))
    one = thh.hh_block_apply_cuda(v[0], t[0], c[0].clone())
    torch.cuda.synchronize()
    close(one, tref.hh_block_apply_ref(v[0], t[0], c[0]),
          wy_tol(dtype, tol, k))


@pytest.mark.cuda
def test_tape_apply_cuda_in_place_and_stripe_invariant(cuda):
    """The kernel updates C in place, and its sums do not depend on how
    many slots share the launch: the large-m path's split of the m rows
    is a function of (m, k, w) alone, so one slot and the same slot among
    200 agree bit for bit."""
    v, t, c = wy_inputs(200, 90, 16, 300, 3, torch.float64, cuda)
    assert thh.launch_shape(90, 16, 300, torch.float64).path == "large"
    c0 = c.clone()
    c4 = c.view(20, 10, 90, 300).clone()
    out = thh.tape_apply_cuda(v, t, c)
    assert out.data_ptr() == c.data_ptr()
    one = thh.tape_apply_cuda(v[:1].contiguous(), t[:1].contiguous(),
                              c0[:1].contiguous())
    # the block apply takes leading axes as slots, in place on its C
    blk = thh.hh_block_apply_cuda(v.view(20, 10, 90, 16),
                                  t.view(20, 10, 16, 16), c4)
    torch.cuda.synchronize()
    assert torch.equal(one[0], out[0])
    assert blk.data_ptr() == c4.data_ptr()
    assert torch.equal(blk.view(200, 90, 300), out)


def _row_table(b, spm, m, r_acc, seed, device):
    """Disjoint rows of each matrix for its spm slots, int32, and the
    accumulator rows no slot names."""
    rows = np.random.default_rng(seed).permutation(r_acc)[:spm * m]
    free = np.setdiff1d(np.arange(r_acc), rows)
    return (torch.from_numpy(rows.reshape(spm, m)).to(device, torch.int32),
            torch.from_numpy(free).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("w", [7, 100])
@pytest.mark.parametrize("m", [1, 17, 64, 65, 200])
@pytest.mark.parametrize("k", [1, 4, 8, 16, 64, 128])
def test_tape_apply_cuda_paths_match_plain(cuda, k, m, w, dtype, tol):
    """Both paths (small m and k: one kernel; else three), m ragged against
    the 32-row stages and 64-row tiles, w = 7 and 100 (rows not on 16 bytes
    at fp64 w = 7 and bf16 w = 100: the element-wise staging)."""
    v, t, c = wy_inputs(3, m, k, w, m * k + w, torch_dtype(dtype), cuda)
    want = tref.tape_apply_ref(v, t, c)
    got = thh.tape_apply_cuda(v, t, c.clone())
    torch.cuda.synchronize()
    close(got, want, wy_tol(dtype, tol, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,w", [(16, 1, 300), (40, 8, 99), (300, 64, 260),
                                   (130, 128, 64)])
def test_tape_apply_cuda_strided_views_match_plain(cuda, m, k, w, dtype,
                                                   tol):
    """V and C as views into larger tensors (rows and columns offset, as
    stage 1's trailing block and the replay's rows below a pivot), updated
    in place: the rest of C stays bit for bit."""
    dt = torch_dtype(dtype)
    v, t, _ = wy_inputs(2, m, k, w, m + w, dt, cuda)
    vpar = torch.zeros((2, m + 3, k + 5), dtype=dt, device=cuda)
    vpar[:, 3:, :k] = v
    cpar = torch.from_numpy(np.random.default_rng(w).standard_normal(
        (2, m + 5, w + 10))).to(cuda, dt)
    before = cpar.clone()
    view = cpar[:, 3:3 + m, 6:6 + w]
    want = tref.tape_apply_ref(vpar[:, 3:, :k], t, view)
    out = thh.tape_apply_cuda(vpar[:, 3:, :k], t, view)
    torch.cuda.synchronize()
    assert out.data_ptr() == view.data_ptr()
    close(view, want, wy_tol(dtype, tol, k))
    view.copy_(before[:, 3:3 + m, 6:6 + w])
    assert torch.equal(cpar, before)
    wide = torch.zeros((2, m, 2 * w), dtype=dt, device=cuda)
    with pytest.raises(ValueError, match="innermost stride"):
        thh.tape_apply_cuda(vpar[:, 3:, :k], t, wide[:, :, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,spm", [(1, 128), (3, 4)])
@pytest.mark.parametrize("m,k,w", [(16, 1, 4096), (17, 1, 101), (96, 16, 64),
                                   (70, 64, 130)])
def test_tape_apply_cuda_row_table_matches_plain(cuda, m, k, w, dtype, tol,
                                                 b, spm):
    """A row table into an accumulator (b, R, w), as the chase replay passes
    it: the kernel against the plain version's gather, apply and scatter,
    both in place; rows no slot names stay bit for bit."""
    dt = torch_dtype(dtype)
    v, t, _ = wy_inputs(b * spm, m, k, 1, m + k, dt, cuda)
    r_acc = spm * m + 9
    rows, free = _row_table(b, spm, m, r_acc, m * spm, cuda)
    acc = torch.from_numpy(np.random.default_rng(w).standard_normal(
        (b, r_acc, w))).to(cuda, dt)
    want = tref.tape_apply_ref(v, t, acc.clone(), rows=rows)
    got = acc.clone()
    before = thh.launches["tape_apply_cuda"]
    assert ops.tape_apply(v, t, got, rows=rows) is got
    torch.cuda.synchronize()
    assert thh.launches["tape_apply_cuda"] == before + 1
    close(got, want, wy_tol(dtype, tol, k))
    assert torch.equal(got[:, free], acc[:, free])
    # a row outside [0, R) is read as zeros and never written
    outside = rows.clone()
    outside[0, -1] = r_acc
    got = acc.clone()
    thh.tape_apply_cuda(v, t, got, outside)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, free], acc[:, free])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,w", [(16, 1, 4096), (300, 64, 260)])
def test_tape_apply_cuda_is_bitwise_reproducible(cuda, m, k, w):
    """Two runs agree bit for bit, and one slot alone agrees bit for bit
    with the same slot among 200, on both paths and through a row table."""
    v, t, c = wy_inputs(200, m, k, w, 5, torch.float64, cuda)
    runs = [thh.tape_apply_cuda(v, t, c.clone()) for _ in range(2)]
    one = thh.tape_apply_cuda(v[:1], t[:1].contiguous(), c[:1].clone())
    rows, _ = _row_table(1, 200, m, 200 * m + 3, 6, cuda)
    acc = torch.zeros((1, 200 * m + 3, w), dtype=torch.float64, device=cuda)
    acc[0, rows.long()] = c
    thh.tape_apply_cuda(v, t, acc, rows)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(one[0], runs[0][0])
    assert torch.equal(acc[0, rows.long()], runs[0])


@pytest.mark.cuda
def test_tape_apply_cuda_replay_shape_is_one_launch(cuda):
    """At the chase replay's shape, (128, 16, 1, 4096) through a row table,
    a call is one device kernel; at the stage-1 panel's, three."""
    from torch.profiler import ProfilerActivity, profile
    v, t, _ = wy_inputs(128, 16, 1, 1, 7, torch.float64, cuda)
    rows, _ = _row_table(1, 128, 16, 128 * 16 + 40, 8, cuda)
    acc = torch.zeros((1, 128 * 16 + 40, 4096), dtype=torch.float64,
                      device=cuda)
    vb, tb, cb = wy_inputs(1, 4224, 64, 4224, 9, torch.float64, cuda)
    for call, kernels in ((lambda: thh.tape_apply_cuda(v, t, acc, rows), 1),
                          (lambda: thh.tape_apply_cuda(vb, tb, cb), 3)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                call()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if "tape_apply_kernel" in ev.key]
        counts = sum(ev.count for ev in prof.key_averages()
                     if "tape_apply_kernel" in ev.key)
        assert counts == 4 * kernels and len(names) == kernels, names


# (n, bw, tw, B) of chip_smoke.py's main-path runs at fuse 1: fp64 n = 4096
# and the warm-up at n = 256 (tw 16), fp32 n = 4096, n = 16384 and the
# stage-2 profile at n = 2048 (tw 32), fp64 B = 32 n = 1024 (bw 32, tw 16);
# each of their stages is a fuse-1 band stage (n, b_in, tw, B)
MAIN_FUSE1_RUNS = [(4096, 64, 16, 1), (256, 64, 16, 1), (4096, 64, 32, 1),
                   (16384, 64, 32, 1), (2048, 64, 32, 1), (1024, 32, 16, 32)]
MAIN_CYCLE_STAGES = sorted({(n, b_in, tw, b)
                            for n, bw, tw0, b in MAIN_FUSE1_RUNS
                            for b_in, tw in stage_plan(bw, tw0)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n,b_in,tw,b", MAIN_CYCLE_STAGES)
def test_chase_cycle_band_matches_windows_and_plain(cuda, n, b_in, tw, b,
                                                    dtype, tol):
    """The fuse-1 band entry (the one-cycle kernel, its band rectangle
    moved by TMA) at a cycle of every main-path fuse-1 stage, with ragged
    live masks: bit for bit the windows entry on the gathered windows and
    the super-step kernel at K = 1 (band, v, live taus; tau = 0 where not
    live; other tape rows untouched), and the plain version within the
    reference's tolerance."""
    dt = torch_dtype(dtype)
    bandp, p32, first, live, t = _stage_tables(n, b_in, tw, 1, b, n + tw, dt,
                                               cuda)
    T, G = p32.shape
    tapes = [_tape_bufs(bandp, T, G, 1, tw) for _ in range(4)]
    bands = [bandp.clone() for _ in range(4)]
    stage = tkern.BandStage(bands[0], p32, first, live, b_in=b_in, tw=tw,
                            fuse=1, tape=tapes[0])
    assert stage.route == "tma"
    with stage:
        stage(t)
    with tkern.BandStage(bands[1], p32, first, live, b_in=b_in, tw=tw,
                         fuse=1, tape=tapes[1], tma=False) as floor:
        assert floor.route == "panels"
        floor(t)
    kw = dict(b_in=b_in, tw=tw)
    tref.chase_cycle_band_ref(bands[2], p32, first, live, t, tape=tapes[2],
                              cycle=tkern.chase_cycle_cuda, **kw)
    tref.chase_cycle_band_ref(bands[3], p32, first, live, t, tape=tapes[3],
                              **kw)
    torch.cuda.synchronize()
    on = live[t][None, :, :, None].expand_as(tapes[0][1][:, t])
    for band_, tape_ in zip(bands[1:3], tapes[1:3]):
        assert torch.equal(bands[0], band_)
        assert torch.equal(tapes[0][0][:, t], tape_[0][:, t])
        assert torch.equal(tapes[0][1][:, t][on], tape_[1][:, t][on])
    assert bool((tapes[0][1][:, t][~on] == 0).all())
    assert bool((tapes[0][0][:, :t] == 7).all()
                and (tapes[0][1][:, t + 1:] == 7).all())
    close(bands[0], bands[3], tol)
    close(tapes[0][0][:, t], tapes[3][0][:, t], tol)
    close(tapes[0][1][:, t], tapes[3][1][:, t], tol)


@pytest.mark.cuda
def test_chase_cycle_band_stage_matches_the_plain_loop(cuda):
    """A whole fuse-1 stage on the card through ``ops.band_stage``: T
    launches of the one-cycle kernel and no eager gather or scatter, the
    band and tape within the stage tolerance of the same stage on the
    CPU."""
    from repro_torch.core import band as tband
    from repro_torch.core import bulge_chasing as bc
    n, bw, tw = 300, 12, 5
    _, T, _ = bc.stage_schedule(n, bw, tw, 1)
    a = np.random.default_rng(12).standard_normal((2, n, n))
    a = np.triu(a) - np.triu(a, bw + 1)
    packed = tband.pack(torch.from_numpy(a), bw, tw)
    kw = dict(n=n, b_in=bw, tw=tw, fuse=1, tape=True)
    want = bc.reduce_stage_packed(packed, backend="ref", **kw)
    before = ops.launch_counts()["chase_cycle_cuda"]
    got = bc.reduce_stage_packed(packed.to(cuda), backend="cuda", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["chase_cycle_cuda"] == before + T
    # the band within test_torch_svd.py's stage tolerance, the reflectors'
    # entries within 1e-9 as in the fuse-4 stage test below: they carry the
    # band's rounding over the pivot gap
    close(got[0], want[0], 1e-11)
    for g_, r_ in zip(got[1:], want[1:]):
        close(g_, r_, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b,n", [(1, 2), (4, 3), (3, 33), (1, 512), (2, 513),
                                 (64, 128), (256, 64), (512, 64),
                                 (2048, 32), (4096, 32)])
def test_sturm_bisect_cuda_is_bitwise_plain(cuda, b, n, dtype):
    """The tree's top counted once, then the walk s levels at a time: the
    same midpoints as the plain bisection, so the same bits, at every s
    that ``bisect.schedule`` picks (5 down to 0 as B*n grows)."""
    z, bound = _gk(n, b, b + n, torch_dtype(dtype), cuda)
    iters = s3.default_bisect_iters(z.dtype)
    got = tbisect.sturm_bisect_cuda(z, bound, n=n, max_iter=iters)
    want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
    torch.cuda.synchronize()
    assert torch.equal(got, want), tbisect.schedule(b, n, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-13), ("float32", 1e-5)])
@pytest.mark.parametrize("n,b", [(1, 3), (2, 4), (33, 3), (512, 1)])
def test_sturm_bisect_cuda_matches_plain(cuda, n, b, dtype, tol):
    if n == 1:
        d = torch.tensor([[-2.5], [0.0], [3.0]], device=cuda,
                         dtype=torch_dtype(dtype))
        got = s3.bidiag_singular_values(d, torch.zeros_like(d))
        assert got.flatten().tolist() == [2.5, 0.0, 3.0]
        return
    z, bound = _gk(n, b, n, torch_dtype(dtype), cuda)
    iters = s3.default_bisect_iters(z.dtype)
    want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
    got = tbisect.sturm_bisect_cuda(z, bound, n=n, max_iter=iters)
    torch.cuda.synchronize()
    close(got, want, tol)
    assert bool((got[:, 1:] <= got[:, :-1]).all())


# ---- divide and conquer (csrc/dc.cu) against bidiag_dc's plain versions --

DC_TOLS = {"float64": 1e-13, "float32": 1e-5}


def _dc_leaves(p, lm, seed, dtype, device):
    """P random leaves, the last one a tight cluster inside an otherwise
    random leaf (rows lm/4 ... lm/2 near 1, coupled by 1e-6): a (P, lm),
    b (P, lm-1) and their brackets, cluster widths and start vectors."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((p, lm))
    b = rng.standard_normal((p, lm - 1))
    c0, c1 = lm // 4, max(lm // 2, lm // 4 + 2)
    a[-1, c0:c1] = 1.0 + 1e-9 * np.arange(c1 - c0)
    b[-1, c0 - 1:c1] = 1e-6
    a, b = (torch.from_numpy(x).to(device, dtype) for x in (a, b))
    lo0, hi0, ctol = tdc._leaf_bracket(a, b)
    return a, b, lo0, hi0, ctol, tdc.leaf_start(lm, dtype, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("leaf_n,p", [(32, 40), (16, 7), (2, 3)])
def test_dc_leaf_cuda_matches_plain(cuda, leaf_n, p, dtype):
    """Eigenvalues bit for bit (the plain version's midpoints), the first
    and last eigenvector rows of the separated leaves within DC_TOLS, and
    in the clustered leaf each cluster's sums of f^2, f*l and l^2 (which
    no rotation inside the cluster changes) within the same."""
    args = _dc_leaves(p, 2 * leaf_n, p + leaf_n, torch_dtype(dtype), cuda)
    kw = dict(bisect_iters=s3.default_bisect_iters(args[0].dtype),
              inv_iters=2)
    got = tdc_kern.dc_leaf_cuda(*args, **kw)
    want = tdc.leaf_eigen_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        close(g[:-1], w[:-1], DC_TOLS[dtype] * 10)
    lam, ctol = want[0][-1], args[4][-1]
    assert bool((lam[1:] - lam[:-1] < ctol).any())     # the leaf clusters
    sums = [_dc_cluster_sums(*x, args[4]) for x in (got, want)]
    close(sums[0][:, -1], sums[1][:, -1], DC_TOLS[dtype] * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("leaf_n", [32, 16, 2])
def test_dc_leaf_cuda_degenerate_cluster_matches_plain(cuda, leaf_n, dtype):
    """Leaves with an exactly repeated eigenvalue (rows lm/4 ... lm/2 at
    0.5, uncoupled): the vectors of the cluster must span the eigenspace,
    so each cluster's sums of f^2, f*l and l^2 agree with the plain
    version's."""
    lm = 2 * leaf_n
    rng = np.random.default_rng(lm)
    a = rng.standard_normal((3, lm))
    b = rng.standard_normal((3, lm - 1))
    c0, c1 = lm // 4, lm // 2 + 1
    a[:, c0:c1] = 0.5
    b[:, c0 - 1:c1] = 0.0
    a, b = (torch.from_numpy(x).to(cuda, torch_dtype(dtype))
            for x in (a, b))
    args = (a, b) + tdc._leaf_bracket(a, b) + (
        tdc.leaf_start(lm, a.dtype, cuda),)
    kw = dict(bisect_iters=s3.default_bisect_iters(a.dtype), inv_iters=2)
    got = tdc_kern.dc_leaf_cuda(*args, **kw)
    want = tdc.leaf_eigen_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    sums = [_dc_cluster_sums(*x, args[4]) for x in (got, want)]
    close(sums[0], sums[1], DC_TOLS[dtype] * 10)


def _dc_cluster_sums(lam, f, l, ctol):
    """(3, P, lm): per cluster of each leaf (a run of eigenvalues whose
    neighbours are within ctol), the sums of f^2, f*l and l^2 over it."""
    start = torch.ones_like(lam, dtype=torch.bool)
    start[:, 1:] = lam[:, 1:] - lam[:, :-1] >= ctol[:, None]
    cid = (torch.cumsum(start.to(torch.int64), -1) - 1).expand(3, -1, -1)
    return torch.zeros((3,) + tuple(lam.shape), dtype=lam.dtype,
                       device=lam.device).scatter_add_(
        -1, cid, torch.stack((f * f, f * l, l * l)))


def _dc_deflation_inputs(p, m, seed, dtype, device):
    """A merge's columns after its first partition, with runs of near-equal
    poles and imbalanced weights, so that the scan merges often."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((p, m)), -1)
    d[:, 1::3] = d[:, 0:-1:3][:, :d[:, 1::3].shape[1]] + 1e-12
    d = np.sort(d, -1)
    z = rng.standard_normal((p, m)) * 10.0 ** rng.integers(-8, 1, (p, m))
    act = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, (p, 1))
    to = lambda x: torch.from_numpy(x).to(device, dtype)  # noqa: E731
    return (to(d), to(z), to(rng.standard_normal((p, m))),
            to(rng.standard_normal((p, m))), torch.from_numpy(act).to(device),
            to(np.full(p, 1e-6)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("p,m", [(1, 1), (3, 2), (5, 200), (64, 128)])
def test_dc_deflate_cuda_is_bitwise_plain(cuda, p, m, dtype):
    args = _dc_deflation_inputs(p, m, p * m, torch_dtype(dtype), cuda)
    want = tdc.deflate_plain(*args)
    got = tdc_kern.dc_deflate_cuda(*(x.clone() for x in args[:5]), args[5])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((~want[4] & args[4]).sum()) > 0 or m < 3   # it did merge


def _dc_secular_inputs(p, m, nact, seed, dtype, device):
    """A merge's secular equation as _merge_pair hands it over: poles
    ascending, weights on the active prefix (of nact[i] poles) only."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((p, m)), -1)
    act = np.arange(m)[None, :] < np.asarray(nact)[:, None]
    w = np.where(act, rng.standard_normal((p, m)) ** 2, 0.0)
    eps = np.finfo(np.float32 if dtype == torch.float32 else np.float64).eps
    d_next = np.pad(d[:, 1:], ((0, 0), (0, 1)))
    a_next = np.pad(act[:, 1:], ((0, 0), (0, 1)))
    gap = np.where(a_next, d_next - d, w.sum(-1, keepdims=True)
                   * (1 + 4 * eps) + 4 * eps * (np.abs(d).max(-1,
                                                              keepdims=True)
                                                + 2))
    to = lambda x: torch.from_numpy(x).to(device, dtype)  # noqa: E731
    act_t, a_next_t = (torch.from_numpy(x).to(device) for x in (act, a_next))
    k = int(max(nact))
    ts = (to(d), to(w), to(gap), act_t, to(d_next), a_next_t)
    hidx = torch.topk(ts[1][:, :k], min(32, k), dim=-1)[1]
    return ts + (hidx,), k, float(np.abs(d).max() + w.sum(-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m,nact", [(4, [4, 1]), (160, [160, 97, 40]),
                                    (1024, [700]), (128, [0, 128])])
def test_dc_secular_cuda_matches_plain(cuda, m, nact, dtype):
    args, k, scale = _dc_secular_inputs(len(nact), m, nact, m,
                                        torch_dtype(dtype), cuda)
    got = tdc_kern.dc_secular_cuda(*args, nact=k, newton_iters=30)
    want = tdc.secular_plain(*args, nact=k, newton_iters=30)
    torch.cuda.synchronize()
    err = float(((got[0] + got[1]) - (want[0] + want[1])).abs().max())
    assert err <= DC_TOLS[dtype] * scale
    assert bool(((got[0] + got[1]) >= args[0][:, :k]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(2048, 1), (512, 4)])
def test_dc_on_a_pipeline_bidiagonal_matches_bisection(cuda, n, b):
    """The bidiagonals stage 2 makes of banded fp64 bw-64 inputs, where the
    reference's dc is off: at n = 2048 a secular root needs more exact
    polish passes than its cap of 12 (3.3e-8 * sigma_max); at n = 512,
    B = 4 a leaf vector collapses in the Gram-Schmidt and its fallback, e_k
    projected, lies across the spectrum (2.4e-11 * sigma_max)."""
    from repro_torch.autotune import measure
    from repro_torch.core import svd as tsvd
    a = measure.banded_input(n, 64, batch=b, dtype=torch.float64,
                             device="cuda")
    d, e = tsvd.bidiagonal_of(a.reshape(b, n, n), bw=64, device="cuda")
    want = s3.bidiag_singular_values(d, e)
    got = tdc.bidiag_dc_singular_values(d, e)
    err = float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())
    assert err <= 1e-12, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b", [("float64", 1000, 1),
                                       ("float64", 300, 3),
                                       ("float32", 2000, 1)])
def test_dc_singular_values_on_the_card_match_the_cpu(cuda, dtype, n, b):
    rng = np.random.default_rng(n)
    d, e = (torch.from_numpy(rng.standard_normal((b, n))).to(
        torch_dtype(dtype)) for _ in range(2))
    ops.reset_launch_counts()
    got = tdc.bidiag_dc_singular_values(d.to(cuda), e.to(cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in tdc_kern.launches), counts
    want = tdc.bidiag_dc_singular_values(d, e)
    close(got.cpu(), want, DC_TOLS[dtype] * (10 if dtype == "float32"
                                             else 1))
    close(got.cpu(), s3.bidiag_singular_values(d, e), 1e-12 if
          dtype == "float64" else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_main_path_on_the_card_matches_the_cpu(cuda, fuse):
    n, bw, tw, B = 96, 8, 3, 3
    a = np.random.default_rng(fuse).standard_normal((B, n, n))
    a = np.triu(a) - np.triu(a, bw + 1)
    ops.reset_launch_counts()
    cfg = PipelineConfig.resolve(bw=bw, tw=tw, dtype=torch.float64, fuse=fuse)
    got = tsvd.banded_singular_values(a, config=cfg, check=True)
    counts = ops.launch_counts()
    assert got.device.type == "cuda"
    kernel = "chase_cycle_cuda" if fuse == 1 else "chase_superstep_cuda"
    assert counts[kernel] > 0 and counts["sturm_bisect_cuda"] == 1
    want = tsvd.banded_singular_values(a, bw=bw, tw=tw, device="cpu")
    s0 = np.linalg.svd(a, compute_uv=False)
    close(got, want, 1e-12)                 # close() scales by sigma_max
    close(got, s0, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [1, 4])
def test_full_svd_on_the_card_matches_the_cpu(cuda, fuse):
    n, bw, tw, B = 72, 8, 3, 2
    a = np.random.default_rng(fuse + 10).standard_normal((B, n, n))
    cfg = PipelineConfig.resolve(bw=bw, tw=tw, dtype=torch.float64, fuse=fuse)
    ops.reset_launch_counts()
    u, s, vt = tsvd.svd(a, config=cfg, check=True)
    counts = ops.launch_counts()
    kernel = "chase_cycle_cuda" if fuse == 1 else "chase_superstep_cuda"
    assert counts[kernel] > 0 and counts["tape_apply_cuda"] > 0
    assert u.device.type == "cuda"
    assert torch.equal(s, tsvd.singular_values(a, config=cfg))
    cpu = dataclasses.replace(cfg, backend="ref", device="cpu")
    uc, sc, vtc = tsvd.svd(a, config=cpu)
    close(s, sc, 1e-12)
    close(u, uc, 1e-9)
    close(vt, vtc, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_uv", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n,bw", FUSED_SHAPES)
def test_fused_small_svd_cuda_matches_plain(cuda, B, n, bw, dtype,
                                            compute_uv):
    a = torch.from_numpy(np.random.default_rng(n * 7 + bw).standard_normal(
        (B, n, n))).to(cuda, torch_dtype(dtype))
    want = tref.fused_small_svd_ref(a, bw=bw, compute_uv=compute_uv)
    got = tfused.fused_small_svd_cuda(a, bw=bw, compute_uv=compute_uv)
    torch.cuda.synchronize()
    tol, tol_uv = tfused.CHECK_TOLS[dtype]
    if not compute_uv:
        close(got, want, tol)
        assert bool((got[:, 1:] <= got[:, :-1]).all())
        return
    (d, e, u, vt), (d0, e0) = got, want[:2]
    assert bool((e[:, 0] == 0).all())
    close(s3.bidiag_singular_values(d, e), s3.bidiag_singular_values(d0, e0),
          tol)
    assert max(tfused.uv_invariants(a, d, e, u, vt)) <= tol_uv
    if dtype == "float64":
        assert tfused.entry_error(got, want) <= tfused.ENTRY_TOL_FP64


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,bw", FUSED_SHAPES)
def test_fused_small_svd_cuda_bf16(cuda, B, n, bw):
    """bf16 works in fp32 and is rounded once, at the store: sigma within a
    bf16 ulp of the scale (2**-7 at most) of the plain version's."""
    a = torch.from_numpy(np.random.default_rng(n * 5 + bw).standard_normal(
        (B, n, n))).to(cuda, torch.bfloat16)
    got = tfused.fused_small_svd_cuda(a, bw=bw)
    assert got.dtype == torch.bfloat16
    close(got, tref.fused_small_svd_ref(a, bw=bw), 1e-2)
    d, e, u, vt = tfused.fused_small_svd_cuda(a, bw=bw, compute_uv=True)
    assert u.dtype == torch.bfloat16 and bool((e[:, 0] == 0).all())
    close(s3.bidiag_singular_values(d, e),
          tref.fused_small_svd_ref(a, bw=bw), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FUSED_ROUTE_CASES)
def test_fused_small_svd_cuda_routes_match_plain(cuda, case):
    """Every route against the plain version, values and uv mode, within
    CHECK_TOLS and ENTRY_TOL_FP64."""
    B, n, bw, dtype, name, j0, uv_smem = case
    dt = torch_dtype(dtype)
    route = tuning.fused_route(n, bw, dt, compute_uv=True)
    assert (route.name, route.j0, route.uv_smem) == (name, j0, uv_smem)
    a = torch.from_numpy(np.random.default_rng(n + bw).standard_normal(
        (B, n, n))).to(cuda, dt)
    tol, tol_uv = tfused.CHECK_TOLS[dtype]
    close(tfused.fused_small_svd_cuda(a, bw=bw),
          tref.fused_small_svd_ref(a, bw=bw), tol)
    got = tfused.fused_small_svd_cuda(a, bw=bw, compute_uv=True)
    want = tref.fused_small_svd_ref(a, bw=bw, compute_uv=True)
    torch.cuda.synchronize()
    assert max(tfused.uv_invariants(a, *got)) <= tol_uv
    if dtype == "float64":
        assert tfused.entry_error(got, want) <= tfused.ENTRY_TOL_FP64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B,n,bw", sorted(
    {(b, n, bw) for b, n, bw, *_ in FUSED_ROUTE_CASES}
    | set(tfused.CHECK_SHAPES)))
def test_fused_small_values_sigma_is_bitwise_plain_bisection(cuda, B, n, bw,
                                                             dtype):
    """Values mode reduces A as uv mode does and bisects in the launch as
    bisect_plain does: its sigma is bit for bit the plain bisection's on the
    (d, e) that uv mode returns, on the same route."""
    a = torch.from_numpy(np.random.default_rng(n * 3 + bw).standard_normal(
        (B, n, n))).to(cuda, torch_dtype(dtype))
    d, e, _, _ = tfused.fused_small_svd_cuda(a, bw=bw, compute_uv=True)
    sig = tfused.fused_small_svd_cuda(a, bw=bw)
    assert torch.equal(sig, s3.bidiag_singular_values(d, e, backend="ref"))


@pytest.mark.cuda
def test_fused_small_values_is_one_launch(cuda):
    n, bw = 48, 8
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, n, n))).to(cuda)
    cfg = PipelineConfig.resolve(bw=bw, dtype=torch.float64, n=n,
                                 backend="fused_small")
    ops.reset_launch_counts()
    sig = tsvd.svd_batched(a, cfg, check=True)
    counts = ops.launch_counts()
    assert counts.pop("fused_small_svd_cuda") == 1
    assert not any(counts.values()), counts
    assert sig.device.type == "cuda" and sig.shape == (5, n)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_uv", [False, True])
def test_fused_small_on_the_card_matches_the_cpu(cuda, compute_uv):
    n, bw, B = 40, 8, 3
    a = np.random.default_rng(6).standard_normal((B, n, n))
    cfg = PipelineConfig.resolve(bw=bw, dtype=torch.float64, n=n,
                                 backend="fused_small")
    got = tsvd.svd_batched(a, cfg, compute_uv=compute_uv, check=True)
    want = tsvd.svd_batched(a, dataclasses.replace(cfg, device="cpu"),
                            compute_uv=compute_uv)
    if not compute_uv:
        close(got, want, 1e-12)
        return
    assert got[0].device.type == "cuda"
    close(got[1], want[1], 1e-12)
    close(got[0], want[0], 1e-9)       # stage 3's vectors, as in the staged
    close(got[2], want[2], 1e-9)       # full-SVD test above


# ---------------------------------------------------------------------------
# causal flash attention (flash_attention.row_error within CHECK_TOLS)
# ---------------------------------------------------------------------------

def _close_rows(got, want, dtype):
    err = tflash.row_error(got, want)
    assert err <= tflash.CHECK_TOLS[dtype], (err, dtype)


def _flash_inputs(bh, s, d, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((bh, s, d))).to(
        device, dtype) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("s", [64, 100, 2048])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_attention_cuda_matches_plain(cuda, d, s, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(3, s, d, s + d, torch_dtype(dtype), cuda)
    got = tflash.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_rows(got, tref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 64, 65, 2047, 2048])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [8, 16, 40, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_cuda_3xtf32_matches_plain(cuda, dtype, d, g, s):
    """``flash_attn.cu`` (3xTF32 products) against the plain version at
    every head width it serves, with k and v of BH or BH / 4 rows, across
    the edges of its query and key tiles: each query row within
    ``CHECK_TOLS`` of its own size."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _grouped_inputs(2, g, s, d, s + d + g, torch_dtype(dtype),
                              cuda)
    got = tflash.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_rows(got, tref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.cuda
def test_flash_attention_cuda_is_causal(cuda):
    """Perturbing future tokens must not change earlier outputs."""
    q, k, v = _flash_inputs(1, 128, 32, 0, torch.float32, cuda)
    o1 = tflash.flash_attention_cuda(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 96:] += 5.0
    v2[:, 96:] += 5.0
    o2 = tflash.flash_attention_cuda(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(o1[:, :96], o2[:, :96])
    assert float((o1[:, 96:] - o2[:, 96:]).abs().max()) > 1e-3


@pytest.mark.cuda
def test_flash_attention_cuda_rejects_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(2, 64, 32, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_cuda(q[:, ::2], k[:, ::2], v[:, ::2])
    with pytest.raises(ValueError, match="dtype"):
        tflash.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="expected q's"):
        tflash.flash_attention_cuda(q, k.half(), v)
    for d in (20, 264):
        x = torch.zeros((1, 8, d), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            tflash.flash_attention_cuda(x, x, x)


@pytest.mark.cuda
def test_flash_attention_counts_its_launches(cuda):
    """Each kernel counts its own launches, and ``ops.flash_attention``
    launches the one ``kernel_for`` names: bf16 at D = 64 the wgmma kernel,
    fp32 ``flash_attn.cu``; the "ref" backend launches neither."""
    keys = ("flash_attention", "flash_attention_wgmma")
    q, k, v = _flash_inputs(2, 70, 64, 2, torch.bfloat16, cuda)
    before = [ops.launch_counts()[key] for key in keys]
    ops.flash_attention(q, k, v)
    assert [ops.launch_counts()[key] for key in keys] == [before[0],
                                                          before[1] + 1]
    ops.flash_attention(q.float(), k.float(), v.float())
    assert [ops.launch_counts()[key] for key in keys] == [before[0] + 1,
                                                          before[1] + 1]
    ops.flash_attention(q, k, v, backend="ref")
    assert [ops.launch_counts()[key] for key in keys] == [before[0] + 1,
                                                          before[1] + 1]


def _grouped_inputs(bh_kv, g, s, d, seed, dtype, device):
    """q (bh_kv * g, s, d) and k, v (bh_kv, s, d) on ``device``."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((bh_kv * g, s, d)))
    k, v = (torch.from_numpy(rng.standard_normal((bh_kv, s, d)))
            for _ in "kv")
    return tuple(x.to(device, dtype) for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 127, 128, 129, 1000, 2047,
                               2048])
def test_flash_attention_wgmma_matches_plain(cuda, s, d, dtype, g):
    """The tensor-core kernel against the plain version, across the ragged
    edge of its 128-row tiles, with k and v of BH or BH / 4 rows."""
    q, k, v = _grouped_inputs(2, g, s, d, s * d + g, torch_dtype(dtype),
                              cuda)
    got = tflash.flash_attention_wgmma_cuda(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    _close_rows(got, tref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.cuda
def test_flash_attention_wgmma_is_causal(cuda):
    """Changing keys and values after row 199 does not move rows 0-199
    (the cut lies inside the second query tile), and moves row 200 on."""
    q, k, v = _grouped_inputs(2, 4, 300, 128, 5, torch.bfloat16, cuda)
    o1 = tflash.flash_attention_wgmma_cuda(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] += 5.0
    v2[:, 200:] += 5.0
    o2 = tflash.flash_attention_wgmma_cuda(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(o1[:, :200], o2[:, :200])
    assert float((o1[:, 200:] - o2[:, 200:]).abs().max()) > 1e-3


@pytest.mark.cuda
def test_flash_attention_wgmma_rejects_what_it_does_not_take(cuda):
    q, k, v = _grouped_inputs(2, 4, 64, 128, 1, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tflash.flash_attention_wgmma_cuda(q.float(), k.float(), v.float())
    x = torch.zeros((2, 64, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_wgmma_cuda(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_wgmma_cuda(q[:, ::2], k[:, ::2], v[:, ::2])
    with pytest.raises(ValueError, match="do not divide"):
        tflash.flash_attention_wgmma_cuda(q, k[:1].expand(3, -1, -1)
                                          .contiguous(), v[:1].expand(
                                              3, -1, -1).contiguous())
    with pytest.raises(ValueError, match="do not divide"):
        tflash.flash_attention_cuda(q.float(), k[:1].float().expand(
            3, -1, -1).contiguous(), v[:1].float().expand(3, -1, -1)
            .contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 128), ("float32", 16),
                                     ("bfloat16", 32), ("float16", 96)])
def test_flash_attention_cuda_grouped_kv(cuda, dtype, d):
    """``flash_attn.cu`` with k and v of BH / 4 rows: query row bh reads KV
    row bh // 4."""
    q, k, v = _grouped_inputs(3, 4, 300, d, d, torch_dtype(dtype), cuda)
    got = tflash.flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    _close_rows(got, tref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.cuda
def test_phi3_width_prefill_on_the_card_matches_the_cpu(cuda):
    """phi3-medium-14b at full width, two layers, fp32 (no TF32): the
    kernel-backed prefill on the card against the plain one on the CPU,
    and two kernel launches.

    Under the reference's init the scores q.k/sqrt(128) are of order 1e2,
    so each softmax is nearly one-hot and amplifies fp32 rounding: the
    plain path on the card and on the CPU, which differ only in the order
    of their sums, disagree by far more than 1e-4 of max|logit|.  The
    limit is ``PREFILL_TOLS["float32"]``, which sits between the sound
    reading at this shape (2.3e-4) and a planted fault's (1.08 or more,
    ``chip_smoke.py --lm-planted-faults`` on an H100 80GB HBM3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("phi3-medium-14b"), n_layers=2,
                              dtype="float32")
    card = build(cfg, device=cuda).init_params(
        torch.Generator(device=cuda).manual_seed(0))
    host = build(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 70))
    before = ops.launch_counts()["flash_attention"]
    got = card.prefill({"tokens": toks})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2
    plain = card.prefill({"tokens": toks}, backend="ref").cpu()
    want = host.prefill({"tokens": toks})
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    witness = float((plain - want).abs().max()) / scale
    err = float((got.cpu() - want).abs().max()) / scale
    assert err <= tflash.PREFILL_TOLS["float32"], (err, witness)


@pytest.mark.cuda
def test_phi3_width_bf16_prefill_on_the_card_launches_wgmma(cuda):
    """phi3-medium-14b at full width, two layers, bf16: the prefill goes
    through the wgmma kernel (two launches, none of ``flash_attn.cu``) and
    its logits stay within ``PREFILL_TOLS["bfloat16"]`` of the same prefill
    through the plain version on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("phi3-medium-14b"), n_layers=2)
    assert cfg.dtype == "bfloat16"
    card = build(cfg, device=cuda).init_params(
        torch.Generator(device=cuda).manual_seed(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 300))
    before = ops.launch_counts()
    got = card.prefill({"tokens": toks})
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert (after["flash_attention_wgmma"], after["flash_attention"]) == (
        before["flash_attention_wgmma"] + 2, before["flash_attention"])
    want = card.prefill({"tokens": toks}, backend="ref")
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max()) / scale
    assert err <= tflash.PREFILL_TOLS["bfloat16"], err


@pytest.mark.cuda
def test_svd_engine_on_the_card_matches_the_cpu(cuda):
    """One fused and one staged (full SVD) bucket through ``AsyncSVDEngine``
    on the card: sigma within 1e-12 * sigma_max of the same engine on the
    CPU, U and V^T reconstructing A, each tier's kernels launched, and the
    clean run with no retry, no degraded and no failed request."""
    from torch_port_common import check_svd

    from repro_torch.serve import AsyncSVDEngine, SVDEngine, SVDRequest
    rng = np.random.default_rng(17)
    stream = ([(rng.standard_normal((24, 24)), False) for _ in range(5)]
              + [(rng.standard_normal((72, 72)), True) for _ in range(3)])

    def reqs():
        return [SVDRequest(uid=i, matrix=a, bw=8, compute_uv=uv)
                for i, (a, uv) in enumerate(stream)]

    ops.reset_launch_counts()
    with AsyncSVDEngine(device="cuda", fused_n_max=32,
                        batch_window_s=0.005) as eng:
        futs = [eng.submit(r) for r in reqs()]
        got = {f.result(timeout=600).uid: f.result(timeout=1) for f in futs}
    counts = ops.launch_counts()
    for k in ("fused_small_svd_cuda", "chase_cycle_cuda",
              "sturm_bisect_cuda", "tape_apply_cuda"):
        assert counts[k] > 0, (k, counts)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == len(stream)
    assert snap["retried"] == snap["degraded"] == snap["failed"] == 0
    assert set(snap["tiers"]) == {"fused", "staged"}
    cpu = SVDEngine(device="cpu", fused_n_max=32)
    for r in reqs():
        cpu.submit(r)
    want = {r.uid: r for r in cpu.run()}
    for uid, r in got.items():
        close(r.sigma, want[uid].sigma, 1e-12)
        if r.compute_uv:
            check_svd(stream[uid][0], r.u, r.sigma, r.vt, 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("tape", [False, True])
def test_superstep_stage_is_one_launch_per_super_cycle(cuda, tape):
    """A fuse-4 stage on the card: T super-step launches (one per
    super-cycle, one device kernel each), no eager gather or scatter
    (``aten::index``, ``aten::index_put_``), and the band and tape of the
    same stage on the CPU.  (Last in the file: a test that profiles after
    this long CPU-and-CUDA trace in the same process was seen to lose
    kernel events.)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import band as tband
    from repro_torch.core import bulge_chasing as bc
    n, bw, tw, fuse = 512, 64, 32, 4
    _, T, _ = bc.stage_schedule(n, bw, tw, fuse)
    a = np.random.default_rng(11).standard_normal((n, n))
    a = np.triu(a) - np.triu(a, bw + 1)
    packed = tband.pack(torch.from_numpy(a), bw, tw)
    kw = dict(n=n, b_in=bw, tw=tw, fuse=fuse, tape=tape)
    want = bc.reduce_stage_packed(packed, backend="ref", **kw)
    dev_packed = packed.to(cuda)
    bc.reduce_stage_packed(dev_packed, backend="cuda", **kw)   # warm-up
    torch.cuda.synchronize()
    before = ops.launch_counts()["chase_superstep_cuda"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = bc.reduce_stage_packed(dev_packed, backend="cuda", **kw)
        torch.cuda.synchronize()
    assert ops.launch_counts()["chase_superstep_cuda"] == before + T
    ka = prof.key_averages()
    assert sum(ev.count for ev in ka
               if ev.key in ("aten::index", "aten::index_put_")) == 0
    assert sum(ev.count for ev in ka
               if "chase_superstep_kernel" in ev.key) == T
    # fp64: the band within test_torch_svd.py's stage tolerance; the
    # reflectors' entries x / (alpha - beta) carry the band's rounding over
    # the pivot gap, and a few of 252,648 lie 4e-10 apart (1e-8 of the
    # entry) after the 957 super-cycles
    close(got[0] if tape else got, want[0] if tape else want, 1e-11)
    for g_, r_ in zip(got[1:] if tape else [], want[1:] if tape else []):
        close(g_, r_, 1e-9)
