"""The port's stage 1 (dense -> band) against the reference, on the CPU.

``band_reduce`` and its reflector tape against the reference's
``band_reduce(backend="ref")`` at fp64 within 1e-12, batched and not, with
inputs made by numpy from fixed seeds; ``wy_t_factor`` against the
reference's; and the trailing update through an in-place apply, as the
CUDA kernel writes (on the trailing block, a view of the padded matrix),
against the plain apply that returns a new tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stage1 as js1
from repro_torch.core import stage1 as ts1
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("nb", [4, 8])
@pytest.mark.parametrize("n", [24, 33, 48])
def test_band_reduce_matches_reference(n, nb, lead):
    a = np.random.default_rng(n * nb).standard_normal(lead + (n, n))
    want, want_tape = js1.band_reduce(jnp.asarray(a), nb=nb, backend="ref",
                                      tape=True)
    got, tape = ts1.band_reduce(torch.from_numpy(a), nb=nb, backend="ref",
                                tape=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)
    for g, w in zip(tape, want_tape):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12,
                                   rtol=0)
    # the tape only records: the band is bit-identical without it
    assert torch.equal(ts1.band_reduce(torch.from_numpy(a), nb=nb), got)
    # banded with bandwidth nb, and the singular values kept
    g = got.numpy()
    assert np.abs(np.tril(g, -1)).max() == 0.0
    assert np.abs(np.triu(g, nb + 1)).max() == 0.0
    np.testing.assert_allclose(np.linalg.svd(g, compute_uv=False),
                               np.linalg.svd(a, compute_uv=False),
                               atol=1e-12 * np.abs(a).max() * n, rtol=0)


def test_batched_equals_looped():
    a = np.random.default_rng(3).standard_normal((3, 20, 20))
    out = ts1.band_reduce(torch.from_numpy(a), nb=4)
    for b in range(3):
        one = ts1.band_reduce(torch.from_numpy(a[b]), nb=4)
        np.testing.assert_allclose(out[b].numpy(), one.numpy(), atol=1e-13,
                                   rtol=0)


@pytest.mark.parametrize("m,k", [(12, 4), (30, 8)])
def test_wy_t_factor_matches_reference(m, k):
    rng = np.random.default_rng(m)
    v = np.tril(rng.standard_normal((m, k)), -1)
    v[np.arange(k), np.arange(k)] = 1.0
    taus = 2.0 / (v * v).sum(0)              # Householder: H_j orthogonal
    want = np.asarray(js1.wy_t_factor(jnp.asarray(v), jnp.asarray(taus)))
    got = ts1.wy_t_factor(torch.from_numpy(v), torch.from_numpy(taus))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # I - V T V^T is the product of the k reflectors
    prod = np.eye(m)
    for j in range(k):
        prod = prod @ (np.eye(m) - taus[j] * np.outer(v[:, j], v[:, j]))
    np.testing.assert_allclose(np.eye(m) - v @ got.numpy() @ v.T, prod,
                               atol=1e-12, rtol=0)
    # batched: one T per leading index
    vb = torch.from_numpy(np.stack([v, 2 * v]))
    tb = torch.from_numpy(np.stack([taus, taus]))
    np.testing.assert_allclose(ts1.wy_t_factor(vb, tb)[0].numpy(),
                               got.numpy(), atol=1e-13, rtol=0)


def test_full_width_route_matches_masked_route(monkeypatch):
    """Stage 1 applies the trailing update to the trailing block, a view
    of the padded matrix.  On "cuda" the apply writes in place; an in-place
    plain apply stands in for the kernel so that route runs on the CPU,
    and it gives the band and tape of the "ref" route (the reference's
    masked route, within 1e-12, is held in the test above)."""
    def in_place(v, t, c):
        c.copy_(tref.tape_apply_ref(v, t, c))
        return c

    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend",
                        lambda b="auto", d="cuda":
                        "cuda" if b == "cuda" else resolve(b, d))
    monkeypatch.setitem(ops._REGISTRY["cuda"], "hh_block_apply", in_place)
    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 33, 33)))
    full, tape = ts1.band_reduce(a, nb=8, backend="cuda", tape=True)
    masked, tape_m = ts1.band_reduce(a, nb=8, backend="ref", tape=True)
    assert torch.equal(full, masked)
    for x, y in zip(tape, tape_m):
        assert torch.equal(x, y)
