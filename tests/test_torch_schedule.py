"""The port's wavefront schedule and tuning knobs against the reference:
integer algebra, so equal exactly."""

import numpy as np
import pytest
import torch

from repro.core import bulge_chasing as jbc
from repro.core import tuning as jtuning
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import tuning as ttuning

torch.set_num_threads(2)

SCHED_CASES = [(16, 2, 1), (24, 4, 2), (32, 8, 4), (33, 7, 6), (48, 5, 2),
               (57, 9, 4), (100, 16, 8), (200, 32, 16), (8, 3, 1),
               (64, 8, 7)]
FUSES = [1, 2, 4, 8]


@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("n,b_in,tw", SCHED_CASES)
def test_schedule_and_indices_match_reference(n, b_in, tw, fuse):
    ref = jbc.stage_schedule(n, b_in, tw, fuse)
    assert tbc.stage_schedule(n, b_in, tw, fuse) == ref
    nsweeps, T, G = ref
    assert ttuning.max_concurrent_sweeps(n, b_in, fuse, tw) == \
        jtuning.max_concurrent_sweeps(n, b_in, fuse, tw)
    assert ttuning.max_concurrent_sweeps(n, b_in, fuse) == \
        jtuning.max_concurrent_sweeps(n, b_in, fuse)
    if T == 0:
        return
    t = np.arange(T)[:, None]
    g = np.arange(G)[None, :]
    want = [np.asarray(x) for x in jbc.chase_cycle_indices(t, g, n, b_in, tw,
                                                           fuse)]
    got = tbc.chase_cycle_indices(torch.arange(T)[:, None],
                                  torch.arange(G)[None, :], n, b_in, tw, fuse)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x.numpy(), np.broadcast_to(w, x.shape))
    # python ints too (the reference's scalar form)
    assert tuple(tbc.chase_cycle_indices(T - 1, 0, n, b_in, tw, fuse)) == \
        tuple(jbc.chase_cycle_indices(T - 1, 0, n, b_in, tw, fuse))


@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("n,b_in,tw", SCHED_CASES)
def test_windows_pairwise_disjoint(n, b_in, tw, fuse):
    """Every (super-)cycle's active slots own pairwise-disjoint windows, so
    the in-place scatter is race-free; and every cycle of every sweep runs
    exactly once."""
    nsweeps, T, G = tbc.stage_schedule(n, b_in, tw, fuse)
    if nsweeps == 0:
        return
    wk = fuse * b_in + tw + 1
    t = torch.arange(T)[:, None]
    g = torch.arange(G)[None, :]
    R, j, p, active, _ = tbc.chase_cycle_indices(t, g, n, b_in, tw, fuse)
    for row_p, row_a in zip(p, active):
        ps = torch.sort(row_p[row_a]).values
        if len(ps) > 1:
            assert bool((ps.diff() >= wk).all()), (ps, wk)
    off = torch.arange(fuse) * b_in
    live = active[..., None] & (p[..., None] + off <= n - 1)
    cycles = (R[..., None] * 10_000 + j[..., None] + torch.arange(fuse))[live]
    assert cycles.numel() == torch.unique(cycles).numel()
    b_out = b_in - tw
    expect = sum((n - 1 - r - b_out) // b_in + 1 for r in range(nsweeps))
    assert cycles.numel() == expect


@pytest.mark.parametrize("bw", [2, 3, 8, 17, 33, 64, 65])
def test_stage_plan_and_tilewidth_match_reference(bw):
    for tw in (1, 3, 8, 16, 31, 32):
        assert ttuning.stage_plan(bw, tw) == jtuning.stage_plan(bw, tw)
    for tdt, jdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        assert ttuning.default_tilewidth(bw, tdt) == \
            jtuning.default_tilewidth(bw, jdt)
    assert ttuning.sweep_separation(1) == jtuning.sweep_separation(1)
    assert ttuning.sweep_separation(4) == jtuning.sweep_separation(4)


def test_smem_budget_counts_and_raises():
    # fp64, b_in=64, tw=16: 17*(81+65+1) words of 8 bytes
    assert ttuning.smem_bytes(64, 16, torch.float64) == 17 * 147 * 8
    # bf16 stages its panels in float32
    assert ttuning.smem_bytes(64, 32, torch.bfloat16) == \
        ttuning.smem_bytes(64, 32, torch.float32)
    # both panel kernels keep their reflector scalars in registers and
    # chase in the same panels whatever the fuse depth
    assert ttuning.smem_bytes(64, 16, torch.float64, fuse=4) == \
        ttuning.smem_bytes(64, 16, torch.float64, fuse=1) == \
        ttuning.smem_bytes(64, 16, torch.float64, fuse=2)
    assert ttuning.check_smem_budget(256, 16, torch.float64) <= \
        ttuning.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        ttuning.check_smem_budget(1024, 64, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        ttuning.PipelineConfig.resolve(bw=1024, tw=64, dtype=torch.float64,
                                       device="cpu")
    assert ttuning.default_fuse_depth(64, 32, torch.float32) == 4
    cfg = ttuning.PipelineConfig.resolve(bw=64, dtype=torch.float32,
                                         fuse=None, device="cpu")
    assert (cfg.tw, cfg.fuse, cfg.backend) == (32, 4, "ref")
