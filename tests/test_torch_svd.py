"""The port's stage 2, stage 3 and entry point against the reference, on the
CPU, with inputs made by numpy from fixed seeds: stage 2 at fp64 within
1e-11, sigma within 1e-10 * sigma_max (the reference's own
``tests/test_svd_pipeline.py`` bound), against numpy's SVD too."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import band as jband
from repro.core import bidiag_svd as jsvd3
from repro.core import bulge_chasing as jbc
from repro.core import svd as jsvd
from repro.core.reference import bidiagonalize_dense_ref
from repro.core.tuning import PipelineConfig as JConfig
from repro_torch import convert
from repro_torch.core import band as tband
from repro_torch.core import bidiag_svd as tsvd3
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig

torch.set_num_threads(2)


def banded(lead, n, bw, seed, dtype=np.float64):
    a = np.random.default_rng(seed).standard_normal(tuple(lead) + (n, n))
    return (np.triu(a) - np.triu(a, bw + 1)).astype(dtype)


def cpu_config(bw, tw, fuse=1, dtype=torch.float64):
    return PipelineConfig.resolve(bw=bw, tw=tw, dtype=dtype, fuse=fuse,
                                  device="cpu")


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("fuse", [1, 4])
def test_reduce_stage_matches_reference(backend, fuse):
    n, bw, tw, B = 33, 7, 3, 2
    mats = banded((B,), n, bw, 10)
    packed = np.array(jband.pack(jnp.asarray(mats), bw, tw))
    want = np.asarray(jbc.reduce_stage_packed(
        jnp.asarray(packed), n=n, b_in=bw, tw=tw, backend=backend, fuse=fuse))
    got = tbc.reduce_stage_packed(convert.band_from_numpy(packed, "cpu"),
                                  n=n, b_in=bw, tw=tw, backend="ref",
                                  fuse=fuse)
    assert got.shape == packed.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-11, rtol=0)


@pytest.mark.parametrize("n,bw,tw", [(40, 8, 3), (24, 5, 4), (17, 2, 1),
                                     (64, 8, 8)])
def test_bidiagonalize_matches_reference_and_oracle(n, bw, tw):
    a = banded((), n, bw, n * bw)
    d_j, e_j = jbc.bidiagonalize(jnp.asarray(a), bw=bw, tw=tw, backend="ref")
    d, e = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw,
                             backend="ref")
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-11, rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-11, rtol=0)
    d_o, e_o, _ = bidiagonalize_dense_ref(a, bw, tw)
    np.testing.assert_allclose(d.numpy(), d_o, atol=1e-10, rtol=0)
    np.testing.assert_allclose(e.numpy()[1:], e_o, atol=1e-10, rtol=0)


def test_bidiagonalize_pallas_interpret_matches():
    n, bw, tw = 28, 6, 2
    a = banded((), n, bw, 3)
    d_j, e_j = jbc.bidiagonalize(jnp.asarray(a), bw=bw, tw=tw,
                                 backend="pallas", fuse=2)
    d, e = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw, fuse=2)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-11, rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-11, rtol=0)


@pytest.mark.parametrize("n,bw,tw", [(48, 8, 3), (30, 6, 5)])
def test_fuse_invariance(n, bw, tw):
    a = torch.from_numpy(banded((2,), n, bw, 7))
    d1, e1 = tbc.bidiagonalize(a, bw=bw, tw=tw, fuse=1)
    for fuse in (2, 4):
        d, e = tbc.bidiagonalize(a, bw=bw, tw=tw, fuse=fuse)
        np.testing.assert_allclose(d.numpy(), d1.numpy(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(e.numpy(), e1.numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("fuse", [1, 2])
def test_batched_equals_looped(fuse):
    n, bw, tw, B = 33, 7, 3, 4
    mats = torch.from_numpy(banded((B,), n, bw, 20))
    packed = tband.pack(mats, bw, tw)
    out = tbc.reduce_stage_packed(packed, n=n, b_in=bw, tw=tw, fuse=fuse)
    for b in range(B):
        one = tbc.reduce_stage_packed(packed[b], n=n, b_in=bw, tw=tw,
                                      fuse=fuse)
        np.testing.assert_array_equal(out[b].numpy(), one.numpy())
    sig = tsvd.banded_singular_values(mats, config=cpu_config(bw, tw, fuse))
    for b in range(B):
        one = tsvd.banded_singular_values(mats[b],
                                          config=cpu_config(bw, tw, fuse))
        np.testing.assert_allclose(sig[b].numpy(), one.numpy(), atol=1e-13,
                                   rtol=0)


@pytest.mark.parametrize("n", [1, 2, 9, 40])
def test_bidiag_singular_values_match_reference(n):
    rng = np.random.default_rng(n)
    d = rng.standard_normal((3, n))
    e = rng.standard_normal((3, n))
    want = np.asarray(jsvd3.bidiag_singular_values(jnp.asarray(d),
                                                   jnp.asarray(e)))
    got = tsvd3.bidiag_singular_values(torch.from_numpy(d),
                                       torch.from_numpy(e)).numpy()
    smax = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-10 * smax, rtol=0)
    for b in range(3):
        bmat = np.diag(d[b]) + np.diag(e[b, 1:], 1)
        s0 = np.linalg.svd(bmat, compute_uv=False)
        np.testing.assert_allclose(got[b], s0, atol=1e-10 * s0[0], rtol=0)
    plain = tsvd3.bidiag_singular_values_plain(torch.from_numpy(d),
                                               torch.from_numpy(e))
    np.testing.assert_array_equal(plain.numpy(), got)


def test_sturm_count_matches_reference():
    rng = np.random.default_rng(4)
    z = rng.standard_normal(15)
    lam = np.linspace(-3, 3, 13)
    want = [int(jsvd3.sturm_count(jnp.asarray(z), jnp.asarray(x)))
            for x in lam]
    got = tsvd3.sturm_count(torch.from_numpy(z), torch.from_numpy(lam))
    assert got.tolist() == want


@pytest.mark.parametrize("lead,n,bw,tw,fuse", [((), 64, 6, 2, 1),
                                               ((3,), 32, 8, 4, 2),
                                               ((2, 2), 24, 5, 3, 4)])
def test_banded_singular_values_match_reference_and_numpy(lead, n, bw, tw,
                                                          fuse):
    a = banded(lead, n, bw, n + bw)
    jcfg = JConfig.resolve(bw=bw, tw=tw, backend="ref", dtype=jnp.float64,
                           n=n, fuse=fuse)
    want = np.asarray(jsvd.banded_singular_values(jnp.asarray(a),
                                                  config=jcfg))
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    got = tsvd.banded_singular_values(a, config=cfg, check=True)
    assert got.shape == lead + (n,) and got.device.type == "cpu"
    s0 = np.linalg.svd(a, compute_uv=False)
    smax = float(s0.max())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10 * smax, rtol=0)
    np.testing.assert_allclose(got.numpy(), s0, atol=1e-10 * smax, rtol=0)


def test_float32_entry_point():
    a = banded((), 48, 8, 5, np.float32)
    got = tsvd.banded_singular_values(a, bw=8, device="cpu")
    assert got.dtype == torch.float32
    s0 = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(got.numpy(), s0, atol=2e-5 * s0[0], rtol=0)


def test_convert_round_trip():
    jcfg = JConfig.resolve(bw=8, tw=3, backend="pallas", dtype=jnp.float64,
                           n=40, fuse=2, unroll=2, max_batch=5)
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg))
    assert (cfg.bw, cfg.tw, cfg.fuse, cfg.dtype, cfg.backend,
            cfg.device) == (8, 3, 2, "float64", "cuda", "cuda")
    assert not hasattr(cfg, "max_batch") and not hasattr(cfg, "unroll")
    ref_fields = dataclasses.asdict(dataclasses.replace(jcfg, backend="ref"))
    cpu = convert.pipeline_config_from_reference(ref_fields, device="cpu")
    assert (cpu.backend, cpu.device) == ("ref", "cpu")
    uv = convert.pipeline_config_from_reference(
        {**ref_fields, "compute_uv": True}, device="cpu")
    assert uv.compute_uv and not cpu.compute_uv
    dc = convert.pipeline_config_from_reference(
        {**ref_fields, "stage3": "dc", "dc_leaf_n": 16, "dc_n_min": 100},
        device="cpu")
    assert (dc.stage3, dc.dc_leaf_n, dc.dc_n_min) == ("dc", 16, 100)
    with pytest.raises(ValueError, match="stage3"):
        convert.pipeline_config_from_reference(
            {**ref_fields, "stage3": "qr"}, device="cpu")
    fused = convert.pipeline_config_from_reference(
        {**ref_fields, "backend": "fused_small"}, device="cpu")
    assert (fused.backend, fused.device) == ("fused_small", "cpu")
    # the same packed state gives the same bidiagonal in both packages
    n, bw, tw = 40, 8, 3
    a = banded((), n, bw, 11)
    packed = np.array(jband.pack(jnp.asarray(a), bw, tw))
    d_j, e_j = jbc.bidiagonalize_packed(jnp.asarray(packed), n=n, bw=bw,
                                        tw=tw, config=jcfg.kernel())
    d, e = tbc.bidiagonalize_packed(convert.band_from_numpy(packed, "cpu"),
                                    n=n, bw=bw, tw=tw, config=cpu)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-11, rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-11, rtol=0)


def test_later_slices_and_conflicts_raise():
    a = banded((), 16, 4, 1)
    assert PipelineConfig.resolve(bw=4, stage3="dc",
                                  device="cpu").stage3 == "dc"
    assert PipelineConfig.resolve(bw=4, n=16, stage3="auto", dc_n_min=17,
                                  device="cpu").stage3 == "bisect"
    with pytest.raises(ValueError, match="stage3"):
        PipelineConfig.resolve(bw=4, stage3="qr", device="cpu")
    assert PipelineConfig.resolve(bw=4, backend="fused_small",
                                  device="cpu").backend == "fused_small"
    cfg = cpu_config(4, 2)
    with pytest.raises(ValueError, match="conflicts"):
        tsvd.banded_singular_values(a, config=cfg, bw=6)
    with pytest.raises(ValueError, match="conflicts"):
        tsvd.banded_singular_values(a.astype(np.float32), config=cfg)
    with pytest.raises(tsvd.NumericalFault):
        tsvd.validate_sigma(torch.tensor([1.0, 2.0]))
    with pytest.raises(tsvd.NumericalFault):
        tsvd.validate_sigma(torch.tensor([1.0, float("nan")]))
