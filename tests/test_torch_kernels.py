"""The port's CUDA kernels against their plain versions, on a card.

Tests marked ``cuda`` skip where there is no CUDA device.  This file imports
no JAX, so it runs on a machine with a card and no JAX, without the
repository's ``conftest.py``:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances are the reference's kernel-test ones (fp32 3e-5, fp64 1e-12,
bf16 8e-2, times the output's scale); bisection agrees to 1e-13 * sigma_max
at fp64 and 1e-5 * sigma_max at fp32.
"""

import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, cuda, torch_dtype, windows  # noqa: F401

from repro_torch.core import bidiag_svd as s3
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import bisect as tbisect
from repro_torch.kernels import bulge_chase as tkern
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

CHASE_SHAPES = [(4, 2, 3), (6, 2, 4), (8, 3, 5), (12, 4, 3), (16, 8, 2),
                (32, 8, 2), (5, 4, 6), (2, 1, 8)]
SUPER_SHAPES = [(4, 2, 3), (8, 3, 4), (5, 4, 3)]
FUSES = [2, 4]


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
    assert ops.launch_counts() == before      # no kernel ran


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
