"""The port's fused small-n tier (``backend="fused_small"``) against the
JAX reference's, on the CPU, with inputs made by numpy from fixed seeds.

Mirrors sections 1-4 of the reference's ``tests/test_fused_small.py``:
sigma within 1e-12 * max(1, sigma_max) of the reference's twin and of
LAPACK at fp64 (5e-4 at fp32); the bidiagonal and the accumulated
transforms within 1e-11 of the twin; the full SVD's reconstruction and
orthogonality within 1e-11; the Pallas kernel itself (interpret mode)
within 1e-12.  On the CPU the tier runs the kernel's plain version,
``kernels/ref.py::fused_small_svd_ref``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import check_svd, close, jit_ref

from repro.core import reference as jreference
from repro.core import svd as jsvd
from repro.core.tuning import PipelineConfig as JConfig
from repro.kernels import fused_small as jfused
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import svd as tsvd
from repro_torch.core import tuning
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)


def dense(n, batch, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, n)).astype(dtype)


def banded(batch, n, bw, seed):
    a = np.random.default_rng(seed).standard_normal((batch, n, n))
    return np.triu(a) - np.triu(a, bw + 1)


def lapack_sigma(a):
    return np.linalg.svd(np.asarray(a, np.float64), compute_uv=False)


def fused_config(n, bw, dtype=torch.float64, compute_uv=False):
    return PipelineConfig.resolve(bw=bw, dtype=dtype, n=n,
                                  backend="fused_small", device="cpu",
                                  compute_uv=compute_uv)


def jax_twin(a, bw, compute_uv=False):
    out = jit_ref(jref.fused_small_svd_ref, bw=bw,
                  compute_uv=compute_uv)(jnp.asarray(a))
    return tuple(np.asarray(x) for x in out) if compute_uv else np.asarray(out)


# ---------------------------------------------------------------------------
# 1. values: the port's fused tier against the reference's twin and LAPACK
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 16, 64])
@pytest.mark.parametrize("bw", [0, 1, 4, "full"])
def test_fused_values_match_reference_and_lapack(n, bw):
    bw = (n - 1) if bw == "full" else bw       # bw = 0 clamps to 1
    a = dense(n, 3, seed=n * 31 + max(bw, 0))
    got = ops.fused_svd(torch.from_numpy(a), bw=bw, backend="fused_small")
    assert got.shape == (3, n) and got.dtype == torch.float64
    s0 = lapack_sigma(a)
    tol = 1e-12 * max(1.0, float(s0.max()))
    np.testing.assert_allclose(got.numpy(), jax_twin(a, bw), atol=tol, rtol=0)
    np.testing.assert_allclose(got.numpy(), s0, atol=tol, rtol=0)


@pytest.mark.parametrize("compute_uv", [False, True])
def test_pallas_kernel_interpret_matches_port(compute_uv):
    """The TPU kernel itself, in interpret mode, against the port."""
    n, bw = 8, 3
    a = dense(n, 2, seed=1)
    want = jfused.fused_small_svd_pallas(jnp.asarray(a), bw=bw,
                                         compute_uv=compute_uv,
                                         interpret=True)
    got = ops.fused_svd(torch.from_numpy(a), bw=bw, compute_uv=compute_uv,
                        backend="fused_small")
    if not compute_uv:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-12)


# ---------------------------------------------------------------------------
# 2. compute_uv: the bidiagonal and transforms, then the full SVD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw", [(2, 1), (16, 4), (33, 7)])
def test_fused_uv_matches_reference_and_reconstructs(n, bw):
    a = dense(n, 2, seed=n)
    d, e, u2, vt2 = ops.fused_svd(torch.from_numpy(a), bw=bw,
                                  compute_uv=True, backend="fused_small")
    for got, want in zip((d, e, u2, vt2), jax_twin(a, bw, compute_uv=True)):
        close(got, want, 1e-11)
    assert bool((e[:, 0] == 0).all())
    cfg = fused_config(n, bw, compute_uv=True)
    u, sig, vt = tsvd.svd(a, config=cfg, check=True)
    check_svd(a, u.numpy(), sig.numpy(), vt.numpy(), 1e-11)
    sig_v = tsvd.svd_batched(a, cfg, compute_uv=False)
    close(sig, sig_v, 1e-13)
    close(sig, lapack_sigma(a), 1e-12)


def test_fused_entry_points_agree():
    """Every entry point routes a fused config through the fused tier."""
    n, bw = 16, 4
    a = dense(n, 2, seed=2)
    cfg = fused_config(n, bw)
    want = tref.fused_small_svd_ref(torch.from_numpy(a), bw=bw)
    for sig in (tsvd.singular_values(a, config=cfg),
                tsvd.batched_singular_values(a, config=cfg, check=True),
                tsvd.svd_batched(a, cfg),
                tsvd.svd(a, config=cfg, compute_uv=False)):
        assert torch.equal(sig, want)
    u, sig, vt = tsvd.svd(a[0], config=cfg)
    assert u.shape == (n, n) and sig.shape == (n,)
    close(sig, want[0], 1e-13)


def test_fused_check_and_stage3():
    a = dense(8, 1, seed=3)
    a[0, 2, 5] = np.nan
    cfg = fused_config(8, 3)
    with pytest.raises(tsvd.NumericalFault):
        tsvd.singular_values(a, config=cfg, check=True)
    # stage 3 by divide and conquer under the fused uv path: the same
    # sigma as bisection's, to rounding
    a = dense(8, 2, seed=4)
    cfg_dc = PipelineConfig.resolve(bw=3, n=8, dtype=torch.float64,
                                    backend="fused_small", stage3="dc",
                                    dc_leaf_n=2, device="cpu")
    assert cfg_dc.stage3 == "dc"
    u, sig, vt = tsvd.svd(a, config=cfg_dc)
    check_svd(a, u, sig, vt, 1e-11)
    close(sig, tsvd.svd(a, config=fused_config(8, 3))[1], 1e-13)


# ---------------------------------------------------------------------------
# 3. banded input, types, the numpy oracle
# ---------------------------------------------------------------------------

def test_fused_banded_input_matches_staged():
    """On a banded input the in-kernel stage 1 is an exact no-op: the fused
    tier equals the port's staged banded path."""
    n, bw = 20, 4
    a = banded(2, n, bw, seed=5)
    sig = tsvd.banded_singular_values(a, config=fused_config(n, bw))
    staged = tsvd.banded_singular_values(a, bw=bw, device="cpu")
    close(sig, staged, 1e-12)
    close(sig, lapack_sigma(a), 1e-12)
    # the vectors of this input's smallest sigma (~1e-6) are stage 3's, as
    # in the staged path; the reconstruction and sigma are the fused tier's
    u, s, vt = tsvd.banded_svd(a, config=fused_config(n, bw))
    close(s, sig, 1e-13)
    close((u * s[:, None, :]) @ vt, a, 1e-11)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-4),
                                       (np.float64, 1e-12)])
def test_fused_values_dtypes(dtype, tol):
    n, bw = 32, 8
    a = dense(n, 2, seed=11, dtype=dtype)
    cfg = fused_config(n, bw, dtype=torch.from_numpy(a).dtype)
    sig = tsvd.svd_batched(a, cfg)
    assert sig.dtype == torch.from_numpy(a).dtype
    close(sig, lapack_sigma(a), tol)


def test_fused_bfloat16_works_in_float32():
    """bf16 input: the plain version works in fp32 and rounds once, so its
    sigma is the fp32 result rounded to bf16 (within a bf16 ulp of the
    scale, 2**-7 at most)."""
    a = torch.from_numpy(dense(16, 2, seed=12)).to(torch.bfloat16)
    sig = ops.fused_svd(a, bw=4, backend="fused_small")
    assert sig.dtype == torch.bfloat16
    close(sig, ops.fused_svd(a.float(), bw=4, backend="fused_small"), 1e-2)
    d, e, u, vt = ops.fused_svd(a, bw=4, compute_uv=True)
    assert u.dtype == vt.dtype == d.dtype == torch.bfloat16
    d32, e32, u32, vt32 = ops.fused_svd(a.float(), bw=4, compute_uv=True)
    for got, want in ((d, d32), (e, e32), (u, u32), (vt, vt32)):
        assert torch.equal(got, want.to(torch.bfloat16))


def test_fused_matches_dense_reference_oracle():
    """On a banded input the fused phase 2 is the numpy oracle's one SBR
    stage at tw = bw - 1: same |d| and |e|."""
    n, bw = 24, 5
    a = banded(1, n, bw, seed=3)
    d_ref, e_ref, _ = jreference.bidiagonalize_dense_ref(a[0].copy(), bw,
                                                         bw - 1)
    d, e, _, _ = ops.fused_svd(torch.from_numpy(a), bw=bw, compute_uv=True,
                               backend="fused_small")
    np.testing.assert_allclose(d[0].abs().numpy(), np.abs(d_ref), atol=1e-10)
    np.testing.assert_allclose(e[0, 1:].abs().numpy(), np.abs(e_ref),
                               atol=1e-10)


# ---------------------------------------------------------------------------
# 4. the shared-memory budget, the backend, convert
# ---------------------------------------------------------------------------

def test_fused_smem_budget():
    # the route's layout (tuning.fused_route): scratch (512 partial sums and
    # the reflector, n; in values mode at least z 2n - 1, two scalars and n
    # int32 counts), the region (phase 1's trailing block, here the whole
    # (64, 65) matrix, or the band), and in uv mode U2 and V2 where they fit
    assert tuning.fused_smem_bytes(64, torch.float32, bw=8) == \
        (512 + 64 + 64 * 65) * 4
    assert tuning.fused_smem_bytes(64, torch.float64, bw=8) == \
        (512 + 64 + 64 * 65) * 8
    assert tuning.fused_smem_bytes(64, torch.float64, bw=8,
                                   compute_uv=True) == \
        (512 + 64 + 3 * 64 * 65) * 8
    assert tuning.fused_smem_bytes(64, torch.bfloat16, bw=8) == \
        tuning.fused_smem_bytes(64, torch.float32, bw=8)
    # what every route needs: the O(n) scratch, max(512 + n, 2n + 2 + n/2)
    # words at fp64
    assert tuning.check_fused_smem_budget(256, torch.float64) == \
        (512 + 256) * 8
    assert tuning.check_fused_smem_budget(4096, torch.float64) == \
        (2 * 4096 + 2 + 2048) * 8
    with pytest.raises(ValueError, match="staged"):
        tuning.check_fused_smem_budget(16384, torch.float64)
    with pytest.raises(ValueError, match="staged"):
        PipelineConfig.resolve(bw=32, dtype=torch.float64, n=16384,
                               backend="fused_small", device="cpu")
    cfg = PipelineConfig.resolve(bw=32, dtype=torch.float32, n=256,
                                 backend="fused_small", device="cpu")
    assert cfg.backend == "fused_small"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fused_small_is_a_complete_backend(device):
    assert ops.resolve_backend("fused_small", device) == "fused_small"
    assert PipelineConfig.resolve(bw=4, backend="fused_small",
                                  device=device).backend == "fused_small"
    for op in ("chase_cycle", "sturm_bisect", "tape_apply",
               "hh_block_apply", "fused_svd"):
        assert ops._impl(op, "fused_small", None, device) is not None


def test_fused_small_backend_runs_the_plain_versions_on_the_cpu():
    a = torch.from_numpy(dense(12, 2, seed=9))
    assert torch.equal(ops.fused_svd(a, bw=3, backend="ref"),
                       ops.fused_svd(a, bw=3, backend="fused_small"))
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 9)))
    bound = z.abs().sum(-1) * 2 + 1
    assert torch.equal(
        ops.sturm_bisect(z, bound, n=5, max_iter=30, backend="ref"),
        ops.sturm_bisect(z, bound, n=5, max_iter=30, backend="fused_small"))
    band = banded(1, 16, 4, seed=6)
    cfg = fused_config(16, 4)
    d, e = tsvd.bidiagonal_of(band, config=cfg)      # staged ops, on "ref"
    d0, e0 = tsvd.bidiagonal_of(band, config=dataclasses.replace(
        cfg, backend="ref"))
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_convert_fused_config_gives_the_same_sigma():
    n, bw = 16, 4
    a = dense(n, 2, seed=13)
    jcfg = JConfig.resolve(bw=bw, dtype=np.float64, n=n,
                           backend="fused_small")
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    assert cfg.backend == "fused_small" and cfg.bw == jcfg.bw
    want = np.asarray(jsvd.svd_batched(jnp.asarray(a), config=jcfg))
    close(tsvd.svd_batched(a, cfg), want, 1e-12)
