"""The port's ``core/distributed.py`` against the reference's, on the CPU:
``shard_pad`` and ``square_embed``; batch dispatch over meshes of 1, 2 and 3
CPU shards (``sharded_singular_values``, ``sharded_svd``) against the
reference's batched functions; the serving engines' mesh dispatch in its
four modes, bit for bit the port's unsharded path, its lost-shard recovery
and its unsharded fallback; ``spectrum_of_params``; and the column-sharded
chase (``reduce_stage_sharded``, ``bidiagonalize_sharded``) against the
reference's ``reduce_stage_packed(..., backend="ref")`` within the
reference's own 1e-11.

A CPU mesh repeats one device: ``launch.mesh.serve_mesh`` never builds
one, so the tests build it by hand."""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import band as bandmod
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import distributed as tdist
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.serve import FaultPlan

torch.set_num_threads(2)

BW = 4


def cpu_mesh(shards):
    return DeviceMesh(["cpu"] * shards)


def dense(seed, b, n=16):
    return np.random.default_rng(seed).standard_normal((b, n, n))


def banded(seed, n, bw):
    a = np.triu(np.random.default_rng(seed).standard_normal((n, n)))
    return a - np.triu(a, bw + 1)


def cfg(max_batch=5, bw=BW, tw=2):
    return PipelineConfig.resolve(bw=bw, tw=tw, backend="ref",
                                  dtype=torch.float64, max_batch=max_batch,
                                  device="cpu")


def rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


# ---------------------------------------------------------------------------
# small helpers against the reference
# ---------------------------------------------------------------------------

def test_shard_pad_and_square_embed_match_the_reference():
    import jax.numpy as jnp
    from repro.core import distributed as rdist
    for b, s in [(8, 4), (9, 4), (1, 8), (5, 1), (0, 3)]:
        assert tdist.shard_pad(b, s) == rdist.shard_pad(b, s)
    rng = np.random.default_rng(0)
    for shape, size in [((5, 3), 4), ((3, 5), 8), ((7, 7), 7), ((9, 2), 4)]:
        w = rng.standard_normal(shape)
        got = tdist.square_embed(torch.tensor(w), size)
        want = np.asarray(rdist.square_embed(jnp.asarray(w), size))
        assert got.shape == (size, size)
        np.testing.assert_array_equal(got.numpy(), want)


def test_process_info_without_a_group():
    assert tdist.process_info() == (0, 1)


# ---------------------------------------------------------------------------
# batch dispatch: sharded_singular_values, sharded_svd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_spectra_match_the_reference(shards):
    import jax.numpy as jnp
    from repro.core import distributed as rdist
    mats = dense(shards, 6)
    mesh = cpu_mesh(shards)
    want = np.asarray(rdist.batched_singular_values(
        jnp.asarray(mats), bw=BW, tw=2, backend="ref"))
    got = tdist.sharded_singular_values(torch.tensor(mats), mesh, bw=BW,
                                        tw=2, backend="ref")
    assert got.shape == (6, 16) and got.device.type == "cpu"
    assert rel(got, want) < 1e-12
    u, s, vt = tdist.sharded_svd(torch.tensor(mats), mesh, bw=BW, tw=2,
                                 backend="ref")
    ru, rs, rvt = (np.asarray(x) for x in rdist.batched_singular_values(
        jnp.asarray(mats), bw=BW, tw=2, backend="ref", compute_uv=True))
    assert rel(s, rs) < 1e-12
    # sigma bit for bit the values path, and both products the matrices'
    assert torch.equal(s, got)
    recon = (u * s[:, None, :]) @ vt
    assert rel(recon, mats) < 1e-12
    assert rel(recon, (ru * rs[:, None, :]) @ rvt) < 1e-12


def test_sharded_spectra_refuse_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="shard_pad"):
        tdist.sharded_singular_values(torch.tensor(dense(0, 5)),
                                      cpu_mesh(2), bw=BW, backend="ref")


# ---------------------------------------------------------------------------
# the serving engines' mesh dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("mode", ["values", "uv", "banded", "banded-uv"])
def test_dispatch_modes_bit_for_bit_unsharded(mode, shards):
    """B = 5 on 2 and 3 shards (padding 1): every result bit for bit the
    port's unsharded path on the same batch, padding dropped."""
    is_banded, uv = mode.startswith("banded"), mode.endswith("uv")
    mats = torch.tensor(dense(7, 5))
    if is_banded:
        mats = torch.triu(mats) - torch.triu(mats, BW + 1)
    c = cfg()
    out = tdist.sharded_pipeline_dispatch(mats, cpu_mesh(shards), config=c,
                                          banded=is_banded, compute_uv=uv)
    ref = tdist._local(mats, c, banded=is_banded, compute_uv=uv)
    outs, refs = (out, ref) if uv else ((out,), (ref,))
    for x, y in zip(outs, refs):
        assert x.shape[0] == 5
        assert torch.equal(x, y)
    s0 = np.linalg.svd(mats.numpy(), compute_uv=False)
    assert rel(outs[1] if uv else out, s0) < 1e-12


def test_lost_shard_recovery_is_bit_for_bit():
    mats = torch.tensor(dense(3, 6))
    c = cfg(max_batch=6)
    mesh = cpu_mesh(3)
    clean = tdist.sharded_pipeline_dispatch(mats, mesh, config=c)
    retries = []
    plan = FaultPlan(shard_loss_at=(0,))          # lose shard 0 of dispatch 0
    tr = obs.Tracer("t")
    with obs.activated(tr):
        out = tdist.sharded_pipeline_dispatch(mats, mesh, config=c,
                                              faults=plan,
                                              on_shard_retry=retries.append)
    assert plan.snapshot()["shard_loss"] == 1
    assert sum(retries) == 1
    assert torch.isfinite(out).all()
    assert torch.equal(clean, out)
    (root,) = tr.roots
    assert root.name == "sharded_dispatch"
    assert [sp.attrs["shard"] for sp in root.find("shard_retry")] == [0]


def test_raising_dispatch_falls_back_unsharded(monkeypatch):
    """A shard that raises takes the sharded dispatch down as a unit: the
    whole padded batch runs again on the mesh's first device, reported as
    ``on_shard_retry(shards)``."""
    mats = torch.tensor(dense(4, 5))
    c = cfg()
    want = tdist._local(mats, c, banded=False, compute_uv=False)
    real = tdist._local

    def flaky(ms, cfg_, **kw):
        if ms.shape[0] < 6:                       # a shard's slice, not all
            raise RuntimeError("device lost")
        return real(ms, cfg_, **kw)

    monkeypatch.setattr(tdist, "_local", flaky)
    retries = []
    tr = obs.Tracer("t")
    with obs.activated(tr):
        out = tdist.sharded_pipeline_dispatch(mats, cpu_mesh(3), config=c,
                                              on_shard_retry=retries.append)
    assert retries == [3]
    assert torch.equal(out, want)
    (root,) = tr.roots
    assert root.attrs.get("fallback") == "unsharded"
    assert root.find("sharded_fallback_unsharded")


# ---------------------------------------------------------------------------
# spectrum_of_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [0, 2])
def test_spectrum_of_params_matches_the_reference(shards):
    import jax.numpy as jnp
    from repro.core import distributed as rdist
    rng = np.random.default_rng(11)
    params = {"embed": rng.standard_normal((12, 8)),
              "layers": {"w": rng.standard_normal((3, 6, 10)),
                         "bias": rng.standard_normal((10,))},
              "head": [rng.standard_normal((9, 9)), rng.standard_normal(4)]}
    jparams = {"embed": jnp.asarray(params["embed"]),
               "layers": {"w": jnp.asarray(params["layers"]["w"]),
                          "bias": jnp.asarray(params["layers"]["bias"])},
               "head": [jnp.asarray(x) for x in params["head"]]}
    want = rdist.spectrum_of_params(jparams, size=16, bw=BW, tw=2,
                                    backend="ref")
    got = tdist.spectrum_of_params(
        params, size=16, bw=BW, tw=2, backend="ref", device="cpu",
        mesh=cpu_mesh(shards) if shards else None)
    assert got["layers"]["bias"] is None and got["head"][1] is None
    assert isinstance(got["head"], list)
    for g, w in [(got["embed"], want["embed"]),
                 (got["layers"]["w"], want["layers"]["w"]),
                 (got["head"][0], want["head"][0])]:
        assert tuple(g.shape) == tuple(w.shape)
        assert rel(g, w) < 1e-12
    assert got["layers"]["w"].shape == (3, 16)


def test_spectrum_of_params_takes_a_state_dict():
    lin = torch.nn.Linear(10, 6).double()
    got = tdist.spectrum_of_params(lin.state_dict(), size=12, bw=BW,
                                   backend="ref", device="cpu")
    assert got["bias"] is None
    s0 = np.linalg.svd(lin.weight.detach().numpy(), compute_uv=False)
    assert rel(got["weight"][:6], s0) < 1e-12
    assert float(got["weight"][6:].abs().max()) < 1e-12


# ---------------------------------------------------------------------------
# one band split by column
# ---------------------------------------------------------------------------

def ref_stage(a, n, b_in, tw):
    import jax.numpy as jnp
    from repro.core import band as rband
    from repro.core import bulge_chasing as rbc
    return np.asarray(rbc.reduce_stage_packed(
        rband.pack(jnp.asarray(a), b_in, tw), n=n, b_in=b_in, tw=tw,
        backend="ref"))


def sharded_stage(packed, n, b_in, tw, d):
    w = b_in + tw + 1
    ncols = max(-(-(n + w) // d) * d, d * w)
    padded = bandmod.pad_columns(packed, ncols - packed.shape[1])
    return tdist.reduce_stage_sharded(padded, n=n, b_in=b_in, tw=tw,
                                      mesh=cpu_mesh(d))[:, :n]


@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_reduce_stage_sharded_matches_the_reference(d, monkeypatch):
    """n = 96, bw 8, tw 3: the reference's own bound, 1e-11; and bit for
    bit the port's unsharded stage.  Each shard's cycles are one
    ``ops.band_stage``, called once a cycle."""
    n, bw, tw = 96, 8, 3
    a = banded(0, n, bw)
    calls = []
    real = ops.band_stage

    def counting(*args, **kw):
        stage = real(*args, **kw)

        def call(t):
            calls.append(t)
            stage(t)
        return call

    monkeypatch.setattr(ops, "band_stage", counting)
    out = sharded_stage(bandmod.pack(torch.tensor(a), bw, tw), n, bw, tw, d)
    monkeypatch.undo()
    assert float(np.abs(out.numpy() - ref_stage(a, n, bw, tw)[:, :n]).max()
                 ) < 1e-11
    local = tbc.reduce_stage_packed(bandmod.pack(torch.tensor(a), bw, tw),
                                    n=n, b_in=bw, tw=tw, backend="ref")
    assert torch.equal(out, local)
    total = tbc.stage_schedule(n, bw, tw)[1]
    assert sorted(calls) == sorted(list(range(total)) * d)


@pytest.mark.parametrize("d", [2, 3])
def test_reduce_stage_sharded_on_a_plan_of_two_stages(d):
    """bw 6, tw 3: the plan (6, 3), (3, 2); each stage, sharded, against the
    reference's stage on the same input."""
    import jax.numpy as jnp
    from repro.core import band as rband
    from repro.core import bulge_chasing as rbc
    from repro.core import tuning as rtuning
    n, bw, tw = 64, 6, 3
    plan = rtuning.stage_plan(bw, tw)
    assert len(plan) == 2
    a = banded(5, n, bw)
    cur_t = bandmod.pack(torch.tensor(a), bw, plan[0][1])
    cur_r = rband.pack(jnp.asarray(a), bw, plan[0][1])
    tw_cur = plan[0][1]
    for b_in, twi in plan:
        start = tw_cur - twi
        h = b_in + 2 * twi + 1
        cur_t = cur_t[start:start + h]
        cur_r = cur_r[start:start + h]
        cur_t = sharded_stage(cur_t, n, b_in, twi, d)
        cur_r = rbc.reduce_stage_packed(cur_r, n=n, b_in=b_in, tw=twi,
                                        backend="ref")
        assert float(np.abs(cur_t.numpy() - np.asarray(cur_r)[:, :n]).max()
                     ) < 1e-11
        tw_cur = twi


@pytest.mark.parametrize("d", [2, 3])
def test_bidiagonalize_sharded_sigma_matches_numpy(d):
    n, bw, tw = 96, 8, 3
    a = banded(2, n, bw)
    dd, e = tdist.bidiagonalize_sharded(a, bw=bw, tw=tw, mesh=cpu_mesh(d))
    b = np.diag(dd.numpy()) + np.diag(e.numpy()[1:], 1)
    s0 = np.linalg.svd(a, compute_uv=False)
    assert rel(np.linalg.svd(b, compute_uv=False), s0) < 1e-11
    d1, e1 = tbc.bidiagonalize(torch.tensor(a), bw=bw, tw=tw, backend="ref")
    assert torch.equal(dd, d1) and torch.equal(e, e1)


def test_reduce_stage_sharded_refuses_a_narrow_or_uneven_band():
    n, b_in, tw = 32, 4, 2
    packed = bandmod.pack(torch.tensor(banded(1, n, b_in)), b_in, tw)
    with pytest.raises(ValueError, match="multiple"):
        tdist.reduce_stage_sharded(bandmod.pad_columns(packed, 7), n=n,
                                   b_in=b_in, tw=tw, mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="cover one chase window"):
        tdist.reduce_stage_sharded(bandmod.pad_columns(packed, 8), n=n,
                                   b_in=b_in, tw=tw, mesh=cpu_mesh(8))
