"""The port's CUDA kernels against their plain versions, on a card.

Tests marked ``cuda`` skip where there is no CUDA device.  This file imports
no JAX, so it runs on a machine with a card and no JAX, without the
repository's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances are the reference's kernel-test ones (fp32 3e-5, fp64 1e-12,
bf16 8e-2, times the output's scale); the compact-WY apply's are fp32 and
fp64 times max(1, k // 4) as well, and bf16 1e-2 times the scale, about one
bf16 ulp (``wy_tol``); bisection agrees to 1e-13 * sigma_max at fp64 and
1e-5 * sigma_max at fp32; causal flash attention, both kernels, with k and
v of BH or BH / g rows, each query row to its own size
(``flash_attention.row_error`` within ``flash_attention.CHECK_TOLS``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port_common import (DTYPES, close, cuda, torch_dtype,  # noqa: F401
                               windows, wy_tol)

from repro_torch.core import bidiag_svd as s3
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import bisect as tbisect
from repro_torch.kernels import bulge_chase as tkern
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
