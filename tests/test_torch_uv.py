"""The port's dense and full-SVD entry points against the reference, on the
CPU, at fp64, with inputs made by numpy from fixed seeds.

``svd``, ``svd_batched`` and ``singular_values`` against the reference's:
U and V^T within 1e-9, sigma within 1e-12 * sigma_max; sigma bit-identical
to the port's own values path; reconstruction and orthogonality below 1e-10
(the bounds of ``tests/test_transforms.py``); the n = 1 path, and
``compute_uv=False`` falling back to the values path.  ``banded_svd`` and
the clustered and orthogonal spectra are in ``test_torch_banded_uv.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import agree, check_svd

from repro.core import bidiag_svd as js3
from repro.core import svd as jsvd
from repro.core.tuning import PipelineConfig as JConfig
from repro_torch import convert
from repro_torch.core import bidiag_svd as ts3
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig

torch.set_num_threads(2)


def cpu_config(bw, tw, fuse=1, **kw):
    return PipelineConfig.resolve(bw=bw, tw=tw, dtype=torch.float64,
                                  fuse=fuse, device="cpu", **kw)


@pytest.mark.parametrize("n,bw,tw,fuse", [(32, 8, 4, 1), (48, 8, 3, 2),
                                          (40, 6, 5, 4)])
def test_svd_matches_reference(n, bw, tw, fuse):
    a = np.random.default_rng(n + fuse).standard_normal((n, n))
    jcfg = JConfig.resolve(bw=bw, tw=tw, backend="ref", dtype=jnp.float64,
                           n=n, fuse=fuse)
    u_j, s_j, vt_j = jsvd.svd(jnp.asarray(a), config=jcfg)
    cfg = cpu_config(bw, tw, fuse)
    u, s, vt = tsvd.svd(a, config=cfg, check=True)
    agree(s, s_j, 1e-12)
    agree(u, u_j, 1e-9)
    agree(vt, vt_j, 1e-9)
    check_svd(a, u, s, vt, 1e-10)
    # sigma bit-identical to the values path
    assert torch.equal(s, tsvd.singular_values(a, config=cfg))


def test_svd_float32_roundtrip():
    """fp32 through the whole full-SVD path: sigma bit-identical to the
    values path, factors within the reference's fp32 bound (5e-4,
    ``tests/test_transforms.py``)."""
    a = np.random.default_rng(11).standard_normal((32, 32)).astype(np.float32)
    cfg = PipelineConfig.resolve(bw=8, tw=4, dtype=torch.float32,
                                 device="cpu")
    u, s, vt = tsvd.svd(a, config=cfg)
    assert u.dtype == s.dtype == vt.dtype == torch.float32
    check_svd(a, u, s, vt, 5e-4)
    assert torch.equal(s, tsvd.singular_values(a, config=cfg))


def test_svd_batched_matches_reference():
    B, n, bw, tw = 3, 24, 6, 3
    mats = np.random.default_rng(2).standard_normal((B, n, n))
    jcfg = JConfig.resolve(bw=bw, tw=tw, backend="ref", dtype=np.float64, n=n)
    u_j, s_j, vt_j = jsvd.svd_batched(jnp.asarray(mats), config=jcfg,
                                      compute_uv=True)
    cfg = cpu_config(bw, tw)
    u, s, vt = tsvd.svd_batched(mats, cfg, compute_uv=True)
    assert u.shape == (B, n, n) and s.shape == (B, n)
    agree(s, s_j, 1e-12)
    agree(u, u_j, 1e-9)
    agree(vt, vt_j, 1e-9)
    check_svd(mats, u, s, vt, 1e-10)
    # batched sigma bit-identical to the values-only batched path
    assert torch.equal(s, tsvd.svd_batched(mats, cfg))
    assert torch.equal(s, tsvd.batched_singular_values(mats, config=cfg))
    # the config's compute_uv is the default; False is the values path
    res = tsvd.svd_batched(mats, dataclasses.replace(cfg, compute_uv=True))
    assert isinstance(res, tuple) and len(res) == 3
    assert torch.equal(tsvd.svd_batched(mats, cfg, compute_uv=False), s)
    with pytest.raises(ValueError, match="stacked"):
        tsvd.svd_batched(mats[0], cfg, compute_uv=True)
    with pytest.raises(ValueError, match="stacked"):
        tsvd.batched_singular_values(mats[0], config=cfg)


def test_bidiag_svd_matches_reference():
    n = 24
    rng = np.random.default_rng(4)
    d = rng.standard_normal((2, n))
    e = np.concatenate([np.zeros((2, 1)), rng.standard_normal((2, n - 1))], 1)
    u_j, s_j, vt_j = js3.bidiag_svd(jnp.asarray(d), jnp.asarray(e))
    u, s, vt = ts3.bidiag_svd(torch.from_numpy(d), torch.from_numpy(e))
    agree(s, s_j, 1e-12)
    agree(u, u_j, 1e-9)
    agree(vt, vt_j, 1e-9)
    for b in range(2):
        bmat = np.diag(d[b]) + np.diag(e[b, 1:], 1)
        check_svd(bmat, u[b], s[b], vt[b], 1e-10)
    # values bit-identical to the bisection entry point
    assert torch.equal(s, ts3.bidiag_singular_values(torch.from_numpy(d),
                                                     torch.from_numpy(e)))


def test_n1_path():
    np.testing.assert_allclose(
        tsvd.singular_values(np.array([[-4.0]]), device="cpu").numpy(), [4.0])
    stack = np.array([[[2.0]], [[-5.0]]])
    cfg = PipelineConfig.resolve(n=1, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tsvd.svd_batched(stack, cfg).numpy(),
                               [[2.0], [5.0]])
    u, s, vt = tsvd.svd_batched(stack, cfg, compute_uv=True)
    assert u.shape == (2, 1, 1) and vt.shape == (2, 1, 1)
    np.testing.assert_allclose((u * s[..., None] * vt).numpy(), stack)
    u_j, s_j, vt_j = jsvd.svd_batched(jnp.asarray(stack), compute_uv=True)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vt_j))
    # bw = 0 resolves to a working (clamped) config
    cfg0 = PipelineConfig.resolve(bw=0, dtype=torch.float64, n=4,
                                  device="cpu")
    a = np.random.default_rng(0).standard_normal((4, 4))
    u4, s4, vt4 = tsvd.svd(a, config=cfg0)
    check_svd(a, u4, s4, vt4, 1e-10)


def test_compute_uv_false_is_the_values_path():
    a = np.random.default_rng(6).standard_normal((20, 20))
    cfg = cpu_config(5, 2)
    s = tsvd.svd(a, config=cfg, compute_uv=False)
    assert isinstance(s, torch.Tensor) and s.shape == (20,)
    assert torch.equal(s, tsvd.singular_values(a, config=cfg))


def test_checks_and_convert():
    """validate_uv and spot_check_svd raise on bad factors; convert carries
    compute_uv across from the reference's config."""
    a = np.random.default_rng(7).standard_normal((12, 12))
    u, s, vt = tsvd.svd(a, bw=4, device="cpu")
    tsvd.spot_check_svd(a, u, s, vt)
    with pytest.raises(tsvd.NumericalFault, match="residual"):
        tsvd.spot_check_svd(a, u, s * 1.01, vt)
    bad = u.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(tsvd.NumericalFault, match="non-finite"):
        tsvd.validate_uv(bad, vt)
    jcfg = JConfig.resolve(bw=4, backend="ref", dtype=np.float64, n=12,
                           compute_uv=True)
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    assert cfg.compute_uv is True
    res = tsvd.svd_batched(a[None], cfg)
    assert isinstance(res, tuple)
    assert torch.equal(res[1][0], s)


def test_entry_points_default_to_the_card():
    a = np.random.default_rng(8).standard_normal((10, 10))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CPU-only rule is moot")
    for fn in (tsvd.singular_values, tsvd.svd, tsvd.banded_svd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(np.triu(a), bw=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsvd.batched_singular_values(a[None], bw=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsvd.svd_batched(a[None], compute_uv=True, bw=3)
