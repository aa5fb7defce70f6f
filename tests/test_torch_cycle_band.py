"""The fuse-1 stage in place on the band, and the Sturm kernels' schedule,
on the CPU.

The fuse-1 stage goes through ``ops.band_stage`` (one ``ops.chase_cycle_band``
call per cycle, the plain version here: gather, ``chase_cycle_ref``,
scatter).  It is held to the reference's ``reduce_stage_packed`` at fuse 1
at the reference's kernel-test tolerances (those of
``test_torch_superstep_band.py``; bf16 by each band's Frobenius norm, for
the reason given there), and to the port's loop before the op existed
(gathered windows through ``ops.chase_cycle``, scattered with
``index_put_``) bit for bit, band and tape, on every stage plan of
chip_smoke.py's main path.  The one-cycle kernel's TMA boxes
(``tuning.cycle_tile``) of one launch are pairwise disjoint on those plans,
and the op raises on a schedule or a padding that would let windows
overlap, and on CPU tensors for the "cuda" backend.

The Sturm kernels count the top of the bisection tree once per matrix and
then walk s levels at a time over groups of lanes (``csrc/sturm.cu``,
``bisect.schedule``).  A plain PyTorch model of that schedule, used only
here, equals ``bisect_plain`` bit for bit: the schedule makes the same
midpoints as the sequential bisection.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, pair, to_np
from torch_port_common import bisect_descend as _descend
from torch_port_common import bisect_walk as _walk

from repro.core import bulge_chasing as jbc
from repro_torch.core import band as tband
from repro_torch.core import bidiag_svd as s3
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import tuning
from repro_torch.kernels import bisect as tbisect
from repro_torch.kernels import ops

torch.set_num_threads(2)

N, BW, TW = 23, 6, 2


def _packed(b, dtype, seed, n=N, bw=BW, tw=TW):
    a = np.random.default_rng(seed).standard_normal((b, n, n))
    a = np.triu(a) - np.triu(a, bw + 1)
    return pair(np.stack([np.asarray(tband.pack(torch.from_numpy(x), bw, tw))
                          for x in a]), dtype)


def _gathered_loop(bandp, p_safe, first, live, *, n, b_in, tw, fuse,
                   backend, config, tape=None):
    """The port's fuse-1 loop before ``ops.chase_cycle_band``: each cycle
    gathers its rolled windows, chases them through ``ops.chase_cycle``,
    records the tape and scatters the stored cells with ``index_put_``."""
    assert fuse == 1
    B, H, _ = bandp.shape
    T, G = p_safe.shape
    W = b_in + tw + 1
    zero = torch.zeros((), dtype=bandp.dtype)
    yy = torch.arange(H)[:, None]
    ww = torch.arange(W)[None, :]
    d_gather = (H - 1 + ww - yy).clamp(0, H - 1)
    vy, vw = (yy >= ww).nonzero(as_tuple=True)
    vd = H - 1 + vw - vy
    vcell = vy * W + vw
    for t in range(T):
        p = p_safe[t]
        win = bandp[:, d_gather, p[:, None, None] + ww]
        out = ops.chase_cycle(win.reshape(B * G, H, W), first[t], b_in=b_in,
                              tw=tw, backend=backend, config=config,
                              with_tape=tape is not None)
        if tape is not None:
            out, vs, taus = out
            tape[0][:, t] = vs.reshape(tape[0].shape[:1] + tape[0].shape[2:])
            taus = taus.reshape(tape[1].shape[:1] + tape[1].shape[2:])
            tape[1][:, t] = torch.where(live[t][None, :, :, None], taus, zero)
        bandp[:, vd, p[:, None] + vw] = out.reshape(B, G, H * W)[:, :, vcell]


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("tape", [False, True])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fuse1_stage_through_band_op_matches_reference(dtype, tol, tape, b):
    jp, tp = _packed(b, dtype, 10 + b)
    kw = dict(n=N, b_in=BW, tw=TW, fuse=1, tape=tape)
    got = tbc.reduce_stage_packed(tp, backend="ref", **kw)
    want = jbc.reduce_stage_packed(
        jp.astype(jnp.float64) if dtype == "bfloat16" else jp,
        backend="ref", **kw)
    got, want = (x if tape else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
    if dtype == "bfloat16":
        norms = [np.linalg.norm(to_np(x).reshape(b, -1), axis=1)
                 for x in (got[0], want[0])]
        np.testing.assert_allclose(norms[0], norms[1], rtol=tol)
    else:
        for g_, w_ in zip(got, want):
            close(g_, w_, tol)


# (bw, tw, dtype) of the stage plans of chip_smoke.py's main path at fuse 1
# (fp64 bw 64 tw 16, fp32 bw 64 tw 32, fp64 bw 32 tw 16), run here at a
# size whose every stage chases
MAIN_PLANS = [(64, 16, "float64"), (64, 32, "float32"), (32, 16, "float64")]


@pytest.mark.parametrize("tape", [False, True])
@pytest.mark.parametrize("bw,tw,dtype", MAIN_PLANS)
def test_fuse1_loop_matches_gathered_loop_bitwise(monkeypatch, bw, tw, dtype,
                                                  tape):
    """The whole plan bw -> 1 through ``_chase_loop`` (one op call per
    cycle) and through the gathered loop: the bidiagonal and every stage's
    tape bit for bit."""
    n, b = 3 * bw + 5, 2
    a = np.random.default_rng(bw + tw).standard_normal((b, n, n))
    a = torch.from_numpy(np.triu(a) - np.triu(a, bw + 1)).to(
        getattr(torch, dtype))
    kw = dict(bw=bw, tw=tw, backend="ref", fuse=1, tape=tape)
    got = tbc.bidiagonalize(a, **kw)
    monkeypatch.setattr(tbc, "_chase_loop", _gathered_loop)
    want = tbc.bidiagonalize(a, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if tape:
        assert len(got[2]) == len(want[2]) == len(tuning.stage_plan(bw, tw))
        for g_, w_ in zip(got[2], want[2]):
            assert torch.equal(g_.v, w_.v) and torch.equal(g_.tau, w_.tau)


@pytest.mark.parametrize("n,bw,tw", [(4096, 64, 16), (256, 64, 16),
                                     (4096, 64, 32), (16384, 64, 32),
                                     (2048, 64, 32), (1024, 32, 16),
                                     (300, 12, 5), (96, 8, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_tma_boxes_of_a_launch_are_disjoint(n, bw, tw, dtype):
    """Where the one-cycle kernel takes a stage, every cycle's live boxes,
    ``box_w`` columns from each window's first column rounded down to 16
    bytes, are pairwise disjoint and hold their windows; the stage's padded
    band rows start on 16-byte boundaries."""
    es = torch.finfo(dtype).bits // 8
    per = 16 // es
    for b_in, twi in tuning.stage_plan(bw, tw):
        nsweeps, T, G = tbc.stage_schedule(n, b_in, twi, 1)
        tile = tuning.cycle_tile(b_in, twi, dtype)
        if nsweeps == 0 or tile is None:
            continue
        box_w = tile[0]
        w = b_in + twi + 1
        n_pad = tuning.band_padding(n, b_in, twi, 1, G)
        assert n_pad * es % 16 == 0 and box_w * es % 16 == 0
        p_safe, _, live = tbc._cycle_table(n, b_in, twi, 1, T, G, 1, "cpu")
        p0 = p_safe - p_safe % per
        assert bool((p0 + box_w >= p_safe + w).all())
        for t in range(T):
            starts = torch.sort(p0[t][live[t, :, 0]]).values
            assert bool((starts.diff() >= box_w).all()), (n, b_in, twi, t)


def test_cycle_band_op_raises_on_overlap_or_short_padding(monkeypatch):
    """At fuse 1, a separation too small for the windows, or a padding
    without room for the dump zones, raises before anything runs."""
    _, tp = _packed(1, "float64", 0)
    _, T, G = tbc.stage_schedule(N, BW, TW, 1)
    w = BW + TW + 1
    p_safe, first, live = tbc._cycle_table(N, BW, TW, 1, T, G, 1, "cpu")
    kw = dict(n=N, b_in=BW, tw=TW)
    narrow = tband.pad_columns(tp, w + G * w - 1)
    with pytest.raises(ValueError, match="dump zones"):
        ops.chase_cycle_band(narrow, p_safe, first, live, 0, **kw)
    with pytest.raises(ValueError, match="dump zones"):
        ops.band_stage(narrow, p_safe, first, live, fuse=1, **kw)
    bandp = tband.pad_columns(tp, w + G * w)
    before = bandp.clone()
    monkeypatch.setattr(tuning, "sweep_separation", lambda fuse=1: 1)
    with pytest.raises(ValueError, match="race-free"):
        ops.chase_cycle_band(bandp, p_safe, first, live, T // 2, **kw)
    with pytest.raises(ValueError, match="race-free"):
        ops.band_stage(bandp, p_safe, first, live, fuse=1, **kw)
    assert torch.equal(bandp, before)


def test_cycle_band_cuda_backend_takes_cuda_tensors_only():
    _, tp = _packed(1, "float64", 1)
    _, T, G = tbc.stage_schedule(N, BW, TW, 1)
    w = BW + TW + 1
    bandp = tband.pad_columns(tp, w + G * w)
    p_safe, first, live = tbc._cycle_table(N, BW, TW, 1, T, G, 1, "cpu")
    p32 = p_safe.to(torch.int32)
    kw = dict(b_in=BW, tw=TW)
    with pytest.raises(ValueError, match="CUDA"):
        ops.chase_cycle_band(bandp, p32, first, live, 0, n=N, backend="cuda",
                             **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ops.band_stage(bandp, p32, first, live, n=N, fuse=1, backend="cuda",
                       **kw)
    from repro_torch.kernels import bulge_chase
    with pytest.raises(ValueError, match="CUDA"):
        bulge_chase.chase_cycle_band_cuda(bandp, p32, first, live, 0, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        bulge_chase.BandStage(bandp, p32, first, live, fuse=1, **kw)


def test_cycle_band_op_on_cpu_is_the_plain_version():
    """``ops.chase_cycle_band`` on CPU tensors: one cycle of the stage, the
    same bits as the gathered loop's cycle, a slot that is not live left as
    it was (and tau = 0 on its tape entries) while the others chase."""
    n = 60
    _, T, G = tbc.stage_schedule(n, BW, TW, 1)
    # random in every stored cell, so that every cycle acts
    bandp = torch.zeros((2, BW + 2 * TW + 1,
                         tuning.band_padding(n, BW, TW, 1, G)),
                        dtype=torch.float64)
    bandp[..., :n] = torch.from_numpy(np.random.default_rng(2).
                                      standard_normal((2, BW + 2 * TW + 1, n)))
    p_safe, first, live = tbc._cycle_table(n, BW, TW, 1, T, G, 2, "cpu")
    w = BW + TW + 1
    inside = live[:, :, 0] & (p_safe + w < n)
    t = int((inside.sum(1) >= 2).nonzero()[0])
    g = int(inside[t].nonzero()[0])
    live[t, g] = False                       # a started slot made not live
    tape = [(torch.full((2, T, G, 1, 2, TW + 1), 7.0, dtype=bandp.dtype),
             torch.full((2, T, G, 1, 2), 7.0, dtype=bandp.dtype))
            for _ in range(2)]
    got, want = bandp.clone(), bandp.clone()
    before = ops.launch_counts()
    ops.chase_cycle_band(got, p_safe, first, live, t, n=n, b_in=BW, tw=TW,
                         tape=tape[0])
    assert ops.launch_counts() == before
    one = slice(t, t + 1)
    _gathered_loop(want, p_safe[one], first[one], live[one], n=n, b_in=BW,
                   tw=TW, fuse=1, backend="ref", config=None,
                   tape=(tape[1][0][:, one], tape[1][1][:, one]))
    p = int(p_safe[t, g])
    assert torch.equal(got[..., p:p + w], bandp[..., p:p + w])
    assert not torch.equal(want[..., p:p + w], bandp[..., p:p + w])
    keep = torch.ones(got.shape[-1], dtype=torch.bool)
    keep[p:p + w] = False
    assert torch.equal(got[..., keep], want[..., keep])
    assert not torch.equal(got, bandp)
    assert torch.equal(tape[0][0], tape[1][0])
    assert bool((tape[0][1][:, t, g] == 0).all())
    others = torch.arange(G) != g
    assert torch.equal(tape[0][1][:, t, others], tape[1][1][:, t, others])


# ---------------------------------------------------------------------------
# The Sturm kernels' schedule
# ---------------------------------------------------------------------------

def sturm_schedule_model(z, bound, *, n, max_iter, d, s):
    """The kernels' bisection in plain torch: the 2^d - 1 nodes of the
    tree's top counted once per matrix, each k walked down them, then
    rounds of s levels (1 where s = 0) whose 2^s - 1 nodes under each k's
    bracket are counted at once and walked."""
    B = z.shape[0]
    k = torch.arange(1, n + 1)
    nodes = torch.arange(1, 2 ** d)
    tlo, thi = _descend(nodes, torch.zeros(B, nodes.numel(), dtype=z.dtype),
                        bound[:, None].expand(B, nodes.numel()).clone())
    top = s3.sturm_count(z, 0.5 * (tlo + thi))          # (B, 2^d - 1)
    lo = torch.zeros(B, n, dtype=z.dtype)
    hi = bound[:, None].expand(B, n).clone()
    lo, hi = _walk(lo, hi, lambda jj: top.gather(1, jj - 1), d, n, k)
    done = d
    while done < max_iter:
        lev = min(max(s, 1), max_iter - done)
        sub = torch.arange(1, 2 ** lev)
        m = sub.numel()
        slo, shi = _descend(sub, lo[..., None].expand(B, n, m),
                            hi[..., None].expand(B, n, m))
        cnt = s3.sturm_count(z, (0.5 * (slo + shi)).reshape(B, n * m))
        cnt = cnt.reshape(B, n, m)
        lo, hi = _walk(lo, hi, lambda jj: cnt.gather(2, (jj - 1)[..., None])
                       [..., 0], lev, n, k)
        done += lev
    return (0.5 * (lo + hi)).flip(-1)


def _bidiag(kind, b, n, seed, dtype):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n))
    e = rng.standard_normal((b, n))
    if kind == "clustered":          # singular values in tight clusters
        d = 1.0 + 1e-7 * np.round(d)
        e = 1e-9 * e
    elif kind == "zero_d":           # zero pivots: the tiny guard acts
        d[:, ::3] = 0.0
        e[:, 1::4] = 0.0
    return s3.gk_problem(torch.from_numpy(d).to(dtype),
                         torch.from_numpy(e).to(dtype))[:2]


@pytest.mark.parametrize("s", [0, 2, 3, 5])
@pytest.mark.parametrize("n", [2, 3, 64, 513])
@pytest.mark.parametrize("kind", ["random", "clustered", "zero_d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sturm_schedule_model_is_bitwise_plain(dtype, kind, n, s):
    b = 2 if n < 513 else 1
    z, bound = _bidiag(kind, b, n, n + s, dtype)
    iters = s3.default_bisect_iters(dtype) if n < 513 else 12
    d = tbisect.schedule(b, n, iters)[0]
    got = sturm_schedule_model(z, bound, n=n, max_iter=iters, d=d, s=s)
    want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
    assert torch.equal(got, want)


@pytest.mark.parametrize("max_iter", [1, 2, 5])
@pytest.mark.parametrize("d", [0, 1, 3])
def test_sturm_schedule_model_short_runs(d, max_iter):
    """max_iter below the tree's top (d = min(floor(log2 n), max_iter)
    then) and tops of any depth up to it give the plain version's bits."""
    z, bound = _bidiag("random", 3, 64, d + max_iter, torch.float64)
    d = min(d, max_iter, tbisect.schedule(3, 64, max_iter)[0])
    for s in (0, 2, 5):
        got = sturm_schedule_model(z, bound, n=64, max_iter=max_iter, d=d,
                                   s=s)
        assert torch.equal(got, s3.bisect_plain(z, bound, n=64,
                                                max_iter=max_iter))


def test_sturm_schedule_choices():
    """d is min(floor(log2 n), max_iter); s is in [0, 5], never 1, and falls
    as B*n grows past what fills the SMs."""
    assert tbisect.schedule(1, 16384, 40)[0] == 14
    assert tbisect.schedule(1, 512, 60) == (9, 5)
    assert tbisect.schedule(3, 64, 2)[0] == 2
    assert tbisect.schedule(1, 1, 60)[0] == 0
    ss = [tbisect.schedule(b, 512, 60)[1] for b in (1, 4, 16, 64, 256, 1024)]
    assert all(0 <= x <= 5 and x != 1 for x in ss)
    assert ss == sorted(ss, reverse=True) and ss[0] == 5 and ss[-1] == 0
