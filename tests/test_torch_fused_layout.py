"""The fused small-n kernel's layout, on the CPU, in plain torch at fp64.

``csrc/fused_small.cu`` applies each reflector to the lines it meets only
(``ref.fused_lines``: a right reflector on row k over columns [lo, hi]
meets rows [k, hi], a left one on column lo over rows [lo, hi] meets
columns [lo, min(hi + bw, n - 1)]), runs phase 1 on the trailing block
A[j:, j:] and phase 2 on the band's diagonals -(bw-1) .. 2bw-1,
diagonal-major.  Here: every entry outside a reflector's lines is an exact
zero when it acts, and phase 2 stays inside those diagonals, with the
reference's arithmetic (``ref._reduce``) at the reference's shapes and the
main path's; ``ref.fused_reduce_band``, the kernel's storage and extents in
plain torch, agrees with the plain version and with the TPU kernel in
interpret mode within ``fused_small.CHECK_TOLS`` and ``ENTRY_TOL_FP64``;
``tuning.fused_route`` lays out shared memory as the kernel needs and
accepts every (n, dtype, mode) the tier accepted before; and the bisection
schedule inside the launch (``fused_small.bisect_schedule``) gives
``bisect_plain``'s bits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cycle_band import _bidiag, sturm_schedule_model
from torch_port_common import close

from repro.kernels import fused_small as jfused
from repro_torch.core import bidiag_svd as s3
from repro_torch.core import tuning
from repro_torch.core.householder import make_reflector
from repro_torch.kernels import fused_small as tfused
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

MAIN = [(64, 8), (256, 32)]                # chip_smoke.py's fused runs
WALK_SHAPES = sorted({(n, bw) for _, n, bw in tfused.CHECK_SHAPES} | set(MAIN))


def dense(b, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, n, n)))


# ---------------------------------------------------------------------------
# 1. extents: the reference's arithmetic meets zeros outside each reflector's
#    lines, and phase 2 stays within diagonals -(bw-1) .. 2bw-1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw", WALK_SHAPES)
def test_reflectors_meet_only_their_lines(n, bw):
    bw = tref.effective_bw(n, bw)
    a = dense(1 if n > 64 else 2, n, n * 13 + bw)
    walk = list(tref.fused_walk(n, bw))
    phase1 = (n - 1) + max(0, n - 1 - bw)
    rows = torch.arange(n)[:, None]
    cols = torch.arange(n)[None, :]
    diag = cols - rows
    outside_band = (diag < -(bw - 1)) | (diag > 2 * bw - 1)
    for step, (right, k, lo, hi) in enumerate(walk):
        first, last = tref.fused_lines(right, k, lo, hi, n, bw)
        s = slice(lo, hi + 1)
        lines = torch.zeros(n, dtype=torch.bool)
        lines[first:last + 1] = True
        # what the reflector would touch off its lines is an exact zero
        off = a[:, ~lines, s] if right else a[:, s, ~lines]
        assert bool((off == 0).all()), (step, right, k, lo, hi)
        if step >= phase1:
            li = torch.arange(first, last + 1)[:, None]
            sup = torch.arange(lo, hi + 1)[None, :]
            d = (sup - li) if right else (li - sup)
            assert int(d.min()) >= -(bw - 1) and int(d.max()) <= 2 * bw - 1
        # the reference's update (ref._reduce)
        if right:
            v, tau, beta = make_reflector(a[:, k, s])
            blk = a[:, :, s]
            w = (blk @ v[:, :, None])[..., 0]
            a[:, :, s] = blk - tau[:, None, None] * (w[:, :, None]
                                                     * v[:, None, :])
            tref._fix_row(a, k, lo, hi, beta, tau)
        else:
            v, tau, beta = make_reflector(a[:, s, k])
            blk = a[:, s, :]
            w = (v[:, None, :] @ blk)[:, 0, :]
            a[:, s, :] = blk - tau[:, None, None] * (v[:, :, None]
                                                     * w[:, None, :])
            tref._fix_col(a, k, lo, hi, beta, tau)
        if step + 1 == phase1:               # phase 1 leaves the upper band
            assert bool((a[:, (diag < 0) | (diag > bw)] == 0).all())
        if step >= phase1:
            assert bool((a[:, outside_band] == 0).all()), step


def test_fused_lines():
    # phase 1 at n = 8, bw = 2: the trailing block
    assert tref.fused_lines(False, 3, 3, 7, 8, 2) == (3, 7)
    assert tref.fused_lines(True, 3, 5, 7, 8, 2) == (3, 7)
    # phase 2: a right reflector's rows [r, hi], a left one's columns up to
    # hi + bw
    assert tref.fused_lines(True, 2, 5, 7, 16, 3) == (2, 7)
    assert tref.fused_lines(False, 5, 5, 7, 16, 3) == (5, 10)
    assert tref.fused_lines(False, 13, 13, 15, 16, 3) == (13, 15)


# ---------------------------------------------------------------------------
# 2. the kernel's storage in plain torch (ref.fused_reduce_band)
# ---------------------------------------------------------------------------

def _routes(n, bw):
    """The route of (n, bw), and, where phase 1 has steps, the same with
    the trailing block moving in half way, and the "global" route."""
    r = tuning.fused_route(n, bw, torch.float64, compute_uv=True)
    out = [r]
    if n >= 4 and r.name == "smem":
        j0 = n // 2
        out.append(dataclasses.replace(
            r, j0=j0, ldt=(n - j0) | 1,
            region=max(r.region, (n - j0) * ((n - j0) | 1))))
        out.append(dataclasses.replace(r, name="global", j0=n - 1))
    return out


@pytest.mark.parametrize("B,n,bw", tfused.CHECK_SHAPES + [(2, 64, 8)])
def test_fused_reduce_band_matches_plain(B, n, bw):
    a = dense(B, n, n * 7 + bw)
    want = tref.fused_small_svd_ref(a, bw=bw, compute_uv=True)
    sig = tref.fused_small_svd_ref(a, bw=bw)
    tol = tfused.CHECK_TOLS["float64"][0]
    for route in _routes(n, tref.effective_bw(n, bw)):
        got = tref.fused_reduce_band(a, bw=bw, compute_uv=True, route=route)
        assert tfused.entry_error(got, want) <= tfused.ENTRY_TOL_FP64, route
        assert bool((got[1][:, 0] == 0).all())
        close(s3.bidiag_singular_values(got[0], got[1], backend="ref"), sig,
              tol * max(1.0, float(sig.abs().max())))
        values = tref.fused_reduce_band(a, bw=bw, route=route)
        assert torch.equal(values[0], got[0]) and torch.equal(values[1],
                                                               got[1])


def test_fused_reduce_band_main_fp32_shape():
    """The fp32 main shape's route, trailing block from column 17, in plain
    torch at fp64 (one matrix): the entries of the plain version."""
    n, bw = 256, 32
    route = tuning.fused_route(n, bw, torch.float32)
    assert route.name == "smem" and 0 < route.j0 < n - 1
    route = dataclasses.replace(route, ldt=(n - route.j0) | 1)
    a = dense(1, n, 3)
    got = tref.fused_reduce_band(a, bw=bw, compute_uv=True, route=route)
    want = tref.fused_small_svd_ref(a, bw=bw, compute_uv=True)
    assert tfused.entry_error(got, want) <= tfused.ENTRY_TOL_FP64


@pytest.mark.parametrize("n,bw", [(8, 3), (12, 4), (9, 1)])
def test_fused_reduce_band_matches_pallas_interpret(n, bw):
    """The TPU kernel itself, in interpret mode, against the layout."""
    a = dense(2, n, n + bw).numpy()
    want = jfused.fused_small_svd_pallas(jnp.asarray(a), bw=bw,
                                         compute_uv=True, interpret=True)
    got = tref.fused_reduce_band(torch.from_numpy(a), bw=bw, compute_uv=True)
    assert tfused.entry_error(got, tuple(torch.from_numpy(np.array(x))
                                         for x in want)) \
        <= tfused.ENTRY_TOL_FP64
    sig = jfused.fused_small_svd_pallas(jnp.asarray(a), bw=bw,
                                        interpret=True)
    close(s3.bidiag_singular_values(got[0], got[1], backend="ref"),
          np.asarray(sig), tfused.CHECK_TOLS["float64"][0])


def test_band_storage_refuses_entries_outside_its_diagonals():
    a = dense(1, 16, 0)
    route = tuning.fused_route(16, 4, torch.float64)
    narrow = dataclasses.replace(route, dlo=route.dlo - 1, h=route.h - 2)
    with pytest.raises(IndexError, match="diagonals"):
        tref.fused_reduce_band(a, bw=4, route=narrow)


# ---------------------------------------------------------------------------
# 3. the route and its shared memory
# ---------------------------------------------------------------------------

def test_fused_route_main_shapes():
    f64, f32 = torch.float64, torch.float32
    r = tuning.fused_route(64, 8, f64)
    assert (r.name, r.j0, r.uv_smem) == ("smem", 0, False)
    ru = tuning.fused_route(64, 8, f64, compute_uv=True)
    assert (ru.name, ru.j0, ru.uv_smem) == ("smem", 0, True)
    # A, U2 and V2 together: three (64, 65) fp64 blocks and the scratch
    assert ru.smem_bytes == (ru.scratch + 3 * 64 * 65) * 8
    g = tuning.fused_route(256, 32, f32)
    assert (g.name, g.j0, g.uv_smem) == ("smem", 17, False)
    assert g.region >= 95 * 257 and g.region >= (256 - 17) * 239
    assert tuning.fused_route(256, 32, f32, compute_uv=True).j0 == 17
    assert tuning.fused_route(256, 32, torch.bfloat16) == g
    for route in (r, ru, g):
        assert route.smem_bytes <= tuning.SMEM_PER_BLOCK
    # fp64 at n = 256: the band fits up to bw = 36, the global route after
    assert tuning.fused_route(256, 36, f64).name == "smem"
    glob = tuning.fused_route(256, 40, f64)
    assert (glob.name, glob.region) == ("global", 0)
    assert glob.smem_bytes == glob.scratch * 8


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("compute_uv", [False, True])
def test_fused_route_layout_is_consistent(dtype, compute_uv):
    """What the kernel's launch checks: the scratch holds phases 1-2's
    partial sums and reflector and phase 3's z, scalars and counts; the
    region holds the band and, from j0, the trailing block; strides odd;
    the byte count is the sum.  Values and uv mode share the route."""
    item = 8 if dtype == torch.float64 else 4
    for n in (1, 2, 3, 16, 33, 64, 100, 256, 1024):
        for bw in sorted({1, 2, 7, 32, n - 1} - {0}):
            r = tuning.fused_route(n, bw, dtype, compute_uv=compute_uv)
            bwe = tref.effective_bw(n, bw)
            assert r.scratch >= tuning.FUSED_THREADS + n
            if not compute_uv:
                assert r.scratch * item >= (2 * n + 2) * item + 4 * n
            if r.name == "smem":
                assert r.dlo == min(bwe - 1, n - 1)
                assert r.h == r.dlo + min(2 * bwe - 1, n - 1) + 1
                assert r.ldb >= n and r.ldb % 2 == 1
                assert r.region >= r.h * r.ldb
                if r.j0 < n - 1:
                    assert r.ldt >= n - r.j0 and r.ldt % 2 == 1
                    assert r.region >= (n - r.j0) * r.ldt
            words = r.scratch + r.region + (2 * n * r.ldu if r.uv_smem
                                            else 0)
            assert r.smem_bytes == words * item <= tuning.SMEM_PER_BLOCK
            assert tuning.fused_smem_bytes(n, dtype, bw=bw,
                                           compute_uv=compute_uv) \
                == r.smem_bytes
            other = tuning.fused_route(n, bw, dtype,
                                       compute_uv=not compute_uv)
            assert (other.name, other.j0) == (r.name, r.j0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("compute_uv", [False, True])
def test_fused_tier_accepts_every_shape_it_accepted(dtype, compute_uv):
    """The tier accepted n while the former O(n) layout fit: 2n + 2 words
    and n (uv) or 2n - 1 (values) more.  Every such n still resolves, and
    the largest n of the former rule runs the global route where its band
    does not fit."""
    item = 8 if dtype == torch.float64 else 4

    def before(n):
        return (2 * n + 2 + (n if compute_uv else 2 * n - 1)) * item \
            <= tuning.SMEM_PER_BLOCK

    top = max(n for n in range(1, 40000) if before(n))
    for n in sorted({1, 2, 3, 64, 170, 171, 255, 256, 257, 1000, 4096,
                     top - 1, top}):
        assert before(n)
        tuning.check_fused_smem_budget(n, dtype, compute_uv=compute_uv)
        for bw in (1, 8, 32):
            r = tuning.fused_route(n, bw, dtype, compute_uv=compute_uv)
            assert r.smem_bytes <= tuning.SMEM_PER_BLOCK
        tuning.PipelineConfig.resolve(bw=8, dtype=dtype, n=n,
                                      backend="fused_small", device="cpu",
                                      compute_uv=compute_uv)
    assert tuning.fused_route(top, 32, dtype).name == "global"


# ---------------------------------------------------------------------------
# 4. the bisection inside the launch
# ---------------------------------------------------------------------------

def test_fused_bisect_schedule_choices():
    """512 threads a matrix: s = 3 at n = 64, none past n = 128 (s = 1
    would count one node a round, as s = 0 does)."""
    assert tfused.bisect_schedule(64, 60) == (6, 3)
    assert tfused.bisect_schedule(256, 40) == (8, 0)
    assert tfused.bisect_schedule(128, 40) == (7, 2)
    assert tfused.bisect_schedule(16, 60) == (4, 5)
    assert tfused.bisect_schedule(1, 60) == (0, 5)
    assert tfused.bisect_schedule(64, 3) == (3, 3)
    for n in range(1, 600, 7):
        d, s = tfused.bisect_schedule(n, 40)
        assert 2 ** d <= n and s != 1 and (n << s <= 512 or s == 0)


@pytest.mark.parametrize("n", [2, 3, 16, 33, 64, 256])
@pytest.mark.parametrize("kind", ["random", "clustered", "zero_d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_bisect_schedule_is_bitwise_plain(dtype, kind, n):
    z, bound = _bidiag(kind, 2, n, n + 1, dtype)
    iters = s3.default_bisect_iters(dtype)
    d, s = tfused.bisect_schedule(n, iters)
    got = sturm_schedule_model(z, bound, n=n, max_iter=iters, d=d, s=s)
    assert torch.equal(got, s3.bisect_plain(z, bound, n=n, max_iter=iters))
