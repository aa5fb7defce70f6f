"""The port's reflector tapes and their replay against the reference, on the
CPU, at fp64.

The chase tapes (fuse 1, 2 and 4) against the reference's
``bidiagonalize(tape=True)``, within 1e-11 of the tape's scale (a
reflector's entries are quotients of band entries, so the band's rounding
differences, ~1e-14, come out a few hundred times larger in the second
stage's tape); ``replay_stage1``, ``replay_chase`` and
``accumulate_transforms`` against the reference's, within 1e-12; the
replayed transforms against first principles (``U^T A V`` is the
bidiagonal the chase produced).  Inputs are made by numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import close

from repro.core import bulge_chasing as jbc
from repro.core import stage1 as js1
from repro.core import transforms as jtr
from repro_torch.core import bulge_chasing as tbc
from repro_torch.core import stage1 as ts1
from repro_torch.core import transforms as ttr

torch.set_num_threads(2)


def banded(lead, n, bw, seed):
    a = np.random.default_rng(seed).standard_normal(tuple(lead) + (n, n))
    return np.triu(a) - np.triu(a, bw + 1)


@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_chase_tapes_match_reference(fuse):
    n, bw, tw = 33, 7, 3
    a = banded((2,), n, bw, fuse)
    d_j, e_j, tapes_j = jbc.bidiagonalize(jnp.asarray(a), bw=bw, tw=tw,
                                          backend="ref", tape=True, fuse=fuse)
    d, e, tapes = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw,
                                    tape=True, fuse=fuse)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), atol=1e-12, rtol=0)
    assert len(tapes) == len(tapes_j) == 2
    for got, want in zip(tapes, tapes_j):
        assert (got.n, got.b_in, got.tw, got.fuse) == (want.n, want.b_in,
                                                       want.tw, want.fuse)
        assert got.v.shape == want.v.shape and got.tau.shape == want.tau.shape
        close(got.tau, want.tau, 1e-11)
        close(got.v, want.v, 1e-11)
    # the tape only records: (d, e) are bit-identical without it
    d0, e0 = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw, fuse=fuse)
    assert torch.equal(d, d0) and torch.equal(e, e0)


def test_inactive_slots_record_zero_tau():
    """Slots whose sweep has not started or has ended, and fused cycles
    past the band's end, record tau = 0 (an identity in the replay)."""
    n, b_in, tw, fuse = 20, 5, 2, 4
    a = banded((), n, b_in, 1)
    from repro_torch.core import band as tband
    packed = tband.pack(torch.from_numpy(a), b_in, tw)
    _, _, taus = tbc.reduce_stage_packed(packed, n=n, b_in=b_in, tw=tw,
                                         fuse=fuse, tape=True)
    T, G = taus.shape[:2]
    t = torch.arange(T)[:, None]
    g = torch.arange(G)[None, :]
    _, _, p, on, _ = tbc.chase_cycle_indices(t, g, n, b_in, tw, fuse)
    live = on[..., None] & (p[..., None] + torch.arange(fuse) * b_in <= n - 1)
    assert bool((taus[~live] == 0).all())
    assert bool((taus[live] != 0).any())


@pytest.mark.parametrize("n,nb,lead", [(24, 4, ()), (30, 6, (2,))])
def test_replay_stage1_matches_reference(n, nb, lead):
    a = np.random.default_rng(n).standard_normal(lead + (n, n))
    _, tape_j = js1.band_reduce(jnp.asarray(a), nb=nb, backend="ref",
                                tape=True)
    banded_t, tape = ts1.band_reduce(torch.from_numpy(a), nb=nb, tape=True)
    b = int(np.prod(lead))
    eye = np.broadcast_to(np.eye(n), (b, n, n))
    flat_j = tuple(jnp.asarray(x).reshape((b,) + x.shape[len(lead):])
                   for x in tape_j)
    ut_j, vt_j = jtr.replay_stage1(jnp.asarray(eye), jnp.asarray(eye), flat_j)
    flat = tuple(x.reshape((b,) + x.shape[len(lead):]) for x in tape)
    ut, vt = ttr.replay_stage1(torch.eye(n, dtype=torch.float64).repeat(
        b, 1, 1), torch.eye(n, dtype=torch.float64).repeat(b, 1, 1), flat)
    np.testing.assert_allclose(ut.numpy(), np.asarray(ut_j), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vt_j), atol=1e-12,
                               rtol=0)
    # U^T A V is the band stage 1 produced
    band = ut.numpy() @ a.reshape(b, n, n) @ vt.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(band, banded_t.numpy().reshape(b, n, n),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("fuse", [1, 4])
def test_replay_chase_matches_reference(fuse):
    n, bw, tw, B = 30, 6, 2, 2
    a = banded((B,), n, bw, 7)
    _, _, tapes_j = jbc.bidiagonalize(jnp.asarray(a), bw=bw, tw=tw,
                                      backend="ref", tape=True, fuse=fuse)
    _, _, tapes = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw,
                                    tape=True, fuse=fuse)
    rng = np.random.default_rng(fuse)
    ut0, vt0 = rng.standard_normal((2, B, n, n))
    tj, tt = tapes_j[0], tapes[0]
    want = jtr.replay_chase(jnp.asarray(ut0), jnp.asarray(vt0), tj.v, tj.tau,
                            n=n, b_in=tj.b_in, tw=tj.tw, fuse=fuse)
    got = ttr.replay_chase(torch.from_numpy(ut0), torch.from_numpy(vt0),
                           tt.v, tt.tau, n=n, b_in=tt.b_in, tw=tt.tw,
                           fuse=fuse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12,
                                   rtol=0)


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("n,bw,tw", [(36, 6, 2), (24, 5, 3), (33, 7, 6)])
def test_accumulate_transforms_matches_reference(n, bw, tw, fuse):
    a = banded((), n, bw, n + bw)
    d_j, e_j, tapes_j = jbc.bidiagonalize(jnp.asarray(a), bw=bw, tw=tw,
                                          backend="ref", tape=True, fuse=fuse)
    u_j, vt_j = jtr.accumulate_transforms(n, chase_tapes=tapes_j,
                                          dtype=jnp.float64)
    d, e, tapes = tbc.bidiagonalize(torch.from_numpy(a), bw=bw, tw=tw,
                                    tape=True, fuse=fuse)
    u, vt = ttr.accumulate_transforms(n, chase_tapes=tapes,
                                      dtype=torch.float64)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vt_j), atol=1e-12,
                               rtol=0)
    bmat = u.numpy().T @ a @ vt.numpy().T
    np.testing.assert_allclose(np.diag(bmat), d.numpy(), atol=1e-11, rtol=0)
    np.testing.assert_allclose(np.diag(bmat, 1), e.numpy()[1:], atol=1e-11,
                               rtol=0)
    off = bmat - np.diag(np.diag(bmat)) - np.diag(np.diag(bmat, 1), 1)
    assert np.abs(off).max() < 1e-11
    assert np.abs(u.numpy().T @ u.numpy() - np.eye(n)).max() < 1e-12


def test_accumulate_with_stage1_tape_batched():
    """Stage 1 and stage 2 tapes together, batched, against the reference:
    ``U^T A V`` is the chase's bidiagonal."""
    n, bw, tw, lead = 26, 5, 2, (2,)
    a = np.random.default_rng(4).standard_normal(lead + (n, n))
    band_j, s1_j = js1.band_reduce(jnp.asarray(a), nb=bw, backend="ref",
                                   tape=True)
    _, _, tapes_j = jbc.bidiagonalize(band_j, bw=bw, tw=tw, backend="ref",
                                      tape=True)
    u_j, vt_j = jtr.accumulate_transforms(n, s1_tape=s1_j,
                                          chase_tapes=tapes_j, lead=lead,
                                          dtype=jnp.float64)
    band_t, s1 = ts1.band_reduce(torch.from_numpy(a), nb=bw, tape=True)
    d, e, tapes = tbc.bidiagonalize(band_t, bw=bw, tw=tw, tape=True)
    u, vt = ttr.accumulate_transforms(n, s1_tape=s1, chase_tapes=tapes,
                                      lead=lead, dtype=torch.float64)
    assert u.shape == lead + (n, n)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), atol=1e-12, rtol=0)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vt_j), atol=1e-12,
                               rtol=0)
    bmat = u.numpy().transpose(0, 2, 1) @ a @ vt.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(np.diagonal(bmat, 0, 1, 2), d.numpy(),
                               atol=1e-11, rtol=0)
    np.testing.assert_allclose(np.diagonal(bmat, 1, 1, 2), e.numpy()[:, 1:],
                               atol=1e-11, rtol=0)
