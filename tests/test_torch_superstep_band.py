"""The fuse-K stage through ``ops.chase_superstep_band``, on the CPU.

The op's plain version (gather, ``chase_superstep_ref``, scatter, tape
writes) drives ``reduce_stage_packed`` at fuse 2 and 4, with and without
the tape, for one and three bands: it is held to the reference's
``reduce_stage_packed`` at the reference's kernel-test tolerances (those of
``test_torch_superstep.py``), and to the port's loop before the op existed
(gathered blocks through ``ops.chase_cycle``) bit for bit.  In bf16 the
entries of a whole stage are not comparable: a reflector's sign follows
the sign of a pivot that rounding can flip, and on some of these inputs
both the reference's bf16 stage and the port's lie more than 1 from the
reference's fp64 stage.  There a stage is held to what any orthogonal reduction keeps, each
band's Frobenius norm, within 8e-2 of the reference's fp64 stage on the
same values.  The blocks one launch chases in place are pairwise disjoint,
dump zones included, for every stage of every plan the main path and the
tests run, and the op raises on a schedule or a padding that would let
them overlap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, pair, to_np

from repro.core import bulge_chasing as jbc
from repro_torch.core import band as tband
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import tuning
from repro_torch.kernels import ops

torch.set_num_threads(2)

N, BW, TW = 23, 6, 2


def _packed(b, dtype, seed):
    a = np.random.default_rng(seed).standard_normal((b, N, N))
    a = np.triu(a) - np.triu(a, BW + 1)
    jp, tp = pair(np.stack([np.asarray(tband.pack(torch.from_numpy(x), BW,
                                                  TW)) for x in a]), dtype)
    return jp, tp


def _gathered_loop(bandp, p_safe, first, live, *, b_in, tw, fuse, tape):
    """The port's fuse-K loop before ``ops.chase_superstep_band``: each
    super-cycle gathers its blocks, chases them through ``ops.chase_cycle``,
    records the tape and scatters."""
    B, H, _ = bandp.shape
    T, G = p_safe.shape
    wk = fuse * b_in + tw + 1
    rows = torch.arange(H)[:, None]
    act = live.repeat(1, B, 1)
    zero = torch.zeros((), dtype=bandp.dtype)
    for t in range(T):
        cols = p_safe[t][:, None, None] + torch.arange(wk)
        res = ops.chase_cycle(bandp[:, rows, cols].reshape(B * G, H, wk),
                              first[t], b_in=b_in, tw=tw, fuse=fuse,
                              active=act[t], with_tape=tape is not None)
        if tape is not None:
            res, vs, taus = res
            tape[0][:, t] = vs.reshape(tape[0].shape[:1] + tape[0].shape[2:])
            taus = taus.reshape(tape[1].shape[:1] + tape[1].shape[2:])
            tape[1][:, t] = torch.where(live[t][None, :, :, None], taus, zero)
        bandp[:, rows, cols] = res.reshape(B, G, H, wk)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("tape", [False, True])
@pytest.mark.parametrize("fuse", [2, 4])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_stage_through_band_op_matches_reference(dtype, tol, fuse, tape, b):
    jp, tp = _packed(b, dtype, 100 * fuse + b)
    kw = dict(n=N, b_in=BW, tw=TW, fuse=fuse, tape=tape)
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
    # the same stage through the gathered loop, bit for bit
    _, T, G = tbc.stage_schedule(N, BW, TW, fuse)
    wk = fuse * BW + TW + 1
    bandp = tband.pad_columns(tp, N + wk + G * wk - N)
    p_safe, first, live = tbc._cycle_table(N, BW, TW, fuse, T, G, b, "cpu")
    bufs = None
    if tape:
        bufs = (tp.new_empty((b, T, G, fuse, 2, TW + 1)),
                tp.new_empty((b, T, G, fuse, 2)))
    _gathered_loop(bandp, p_safe, first, live, b_in=BW, tw=TW, fuse=fuse,
                   tape=bufs)
    assert torch.equal(got[0], bandp[..., :N])
    if tape:
        assert torch.equal(got[1], bufs[0]) and torch.equal(got[2], bufs[1])


# (n, bw, tw) of every fuse-K stage plan chip_smoke.py's main path runs
# (fp64 bw 64 tw 16 at n = 4096 and 256; fp32 bw 64 tw 32 at n = 16384 and
# 2048; fp32 bw 32 tw 31 at n = 512) and of the tests' stages
MAIN_PLANS = [(4096, 64, 16), (256, 64, 16), (16384, 64, 32), (2048, 64, 32),
              (512, 32, 31)]
TEST_PLANS = [(N, BW, TW), (512, 64, 32), (300, 12, 5), (33, 7, 3),
              (48, 8, 3), (30, 6, 5), (28, 6, 2), (20, 5, 2), (40, 8, 3),
              (24, 5, 4), (64, 8, 8), (96, 8, 4)]


@pytest.mark.parametrize("fuse", [1, 2, 4])
@pytest.mark.parametrize("n,bw,tw", MAIN_PLANS + TEST_PLANS)
def test_blocks_of_a_launch_are_disjoint(n, bw, tw, fuse):
    """Every (super-)cycle's blocks, [p_safe, p_safe + fuse*b_in + tw + 1)
    for every slot (live slots at their pivot column, the others at their
    dump zones), are pairwise disjoint and lie inside the padded band, at
    every stage of the plan; ``tuning.check_disjoint_blocks`` agrees."""
    for b_in, twi in tuning.stage_plan(bw, tw):
        nsweeps, T, G = tbc.stage_schedule(n, b_in, twi, fuse)
        if nsweeps == 0:
            continue
        wk = fuse * b_in + twi + 1
        ncols = n + wk + G * wk
        tuning.check_disjoint_blocks(n, b_in, twi, fuse, G, ncols)
        p_safe, _, _ = tbc._cycle_table(n, b_in, twi, fuse, T, G, 1, "cpu")
        p = torch.sort(p_safe, dim=1).values
        assert bool((p[:, 0] >= 0).all()) and bool((p[:, -1] + wk
                                                    <= ncols).all())
        assert bool((p.diff(dim=1) >= wk).all()), (n, b_in, twi, fuse)


def test_band_op_raises_on_overlapping_schedule(monkeypatch):
    """A separation too small for the blocks' width, or a padding without
    room for the dump zones, raises before anything runs."""
    fuse, b = 2, 1
    _, tp = _packed(b, "float64", 0)
    _, T, G = tbc.stage_schedule(N, BW, TW, fuse)
    wk = fuse * BW + TW + 1
    p_safe, first, live = tbc._cycle_table(N, BW, TW, fuse, T, G, b, "cpu")
    kw = dict(n=N, b_in=BW, tw=TW, fuse=fuse)
    narrow = tband.pad_columns(tp, wk + G * wk - 1)
    with pytest.raises(ValueError, match="dump zones"):
        ops.chase_superstep_band(narrow, p_safe, first, live, 0, **kw)
    bandp = tband.pad_columns(tp, wk + G * wk)
    before = bandp.clone()
    monkeypatch.setattr(tuning, "sweep_separation", lambda fuse=1: 1)
    with pytest.raises(ValueError, match="race-free"):
        ops.chase_superstep_band(bandp, p_safe, first, live, T // 2, **kw)
    assert torch.equal(bandp, before)
    with pytest.raises(ValueError, match="race-free"):
        tuning.check_disjoint_blocks(N, BW, TW, fuse, G, 10 ** 6)


def test_band_op_cuda_backend_takes_cuda_tensors_only():
    fuse, b = 2, 1
    _, tp = _packed(b, "float64", 1)
    _, T, G = tbc.stage_schedule(N, BW, TW, fuse)
    wk = fuse * BW + TW + 1
    bandp = tband.pad_columns(tp, wk + G * wk)
    p_safe, first, live = tbc._cycle_table(N, BW, TW, fuse, T, G, b, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.chase_superstep_band(bandp, p_safe.to(torch.int32), first, live,
                                 0, n=N, b_in=BW, tw=TW, fuse=fuse,
                                 backend="cuda")
    from repro_torch.kernels import bulge_chase
    with pytest.raises(ValueError, match="CUDA"):
        bulge_chase.chase_superstep_band_cuda(
            bandp, p_safe.to(torch.int32), first, live, 0, b_in=BW, tw=TW,
            fuse=fuse)
